"""The decode's step as one launch on the card (`csrc/decode_step.cu`,
`step::step_kernel`, the step route of `persistent_greedy_decode`) against
the plain version `greedy_decode_reference`: ep221 on the serving drawings
at B = 1, 5 and 64, with early exit on and off, at the side-face (256 keys)
and visible (512, 560) buckets, and on a ragged mask (a row with no real
key, one with only key 0, a masked key inside a row); bf16 decodes take
the route `route_of` gives their plan (the chain on mma.sync past one wave
of clusters, B=512) with the plain version's tokens; an f32 decode takes
the chain and gives the plain version's tokens. On both routes, a call
that finds its shape's launch state and its packed weights kept gives a
fresh decode's tokens, attach, steps and hidden bit for bit: after a
longer decode of the shape, after an in-place update of the weights, and
after the shape was dropped past `GRAPH_SHAPES` and built again; and the
tensors an earlier call returned stay as they were. Needs a CUDA device
(skips without one):

  python -m pytest --noconftest tests/test_torch_decode_step_card.py -q

(`--noconftest`: `tests/conftest.py` sets up JAX, which a machine with
the card need not have)
"""
import copy
import gzip
import json
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")
FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
# the bf16 bar of the port (ROADMAP.md): token agreement with the plain
# version, which rounds at other places
AGREEMENT = 0.99


@pytest.fixture(scope="module")
def served():
    """ep221 and the 64 serving drawings encoded at the golden's bucket, in
    bf16 and in f32: {(dtype, bucket): (memory, mask)}, params, dims, and
    `at(cd, bucket)`, which encodes them at another bucket (cropped or
    padded). Skips unless a CUDA device is present (decided here, never
    while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the decode's step kernel runs on the "
                    "card only")
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.decode import _pad_or_crop
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.serving import pack_info_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    params, cfg = load_checkpoint(CKPT, device=dev)
    dims = ModelDims.from_config(cfg)
    with gzip.open(os.path.join(FIXTURES, "serve64.json.gz"), "rt") as f:
        infos = json.load(f)
    bucket = int(np.load(os.path.join(FIXTURES,
                                      "serve64_jax_golden.npz"))["bucket"])
    packed = [pack_info_dict(info, cfg) for info in infos]
    batch = {k: torch.from_numpy(np.stack([p[k] for p in packed])).to(dev)
             for k in packed[0]}
    mem = {}

    def at(cd, Li=bucket):
        if (cd, Li) not in mem:
            inputs = _pad_or_crop(batch, Li, dims)
            with torch.no_grad():
                mem[cd, Li] = (encode(params, inputs, dims, compute_dtype=cd,
                                      flash=True), inputs["input_mask"])
        return mem[cd, Li]
    return at, params, dims


def _ragged(mask):
    """Row 0 with no real key, row 1 with only key 0, row 2 with its middle
    real key masked."""
    rag = mask.clone()
    rag[0] = True
    rag[1] = True
    rag[1, 0] = False
    real = torch.nonzero(~mask[2]).flatten()
    rag[2, real[real.numel() // 2]] = True
    return rag


def _both(served, B, early_exit, ragged=False, cd=torch.bfloat16, Li=None,
          route="step"):
    """The CUDA decode on route `route` (None: `route_of`'s) and the plain
    version of the last B drawings (tiled past 64) at bucket Li."""
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    at, params, dims = served
    memory, mask = at(cd) if Li is None else at(cd, Li)
    rows = torch.arange(-B, 0) % memory.shape[0]
    memory, mask = memory[rows], mask[rows]
    if ragged:
        mask = _ragged(mask)
    before = dict(PD.launches_by_route)
    saved = PD.route_of
    if route:
        PD.route_of = lambda cd, plan: route
    try:
        got = PD.persistent_greedy_decode(params, memory, mask, dims,
                                          compute_dtype=cd,
                                          early_exit=early_exit)
        torch.cuda.synchronize()
    finally:
        PD.route_of = saved
    counted = {k: PD.launches_by_route[k] - before[k] for k in before}
    want = PD.greedy_decode_reference(params, memory, mask, dims,
                                      compute_dtype=cd, early_exit=early_exit)
    return got, want, counted, dict(PD.last_graph), dims


@pytest.mark.card
@pytest.mark.parametrize("early_exit", [True, False], ids=["early", "all"])
@pytest.mark.parametrize("B", [1, 5, 64])
def test_step_route_matches_the_plain_decode(served, B, early_exit):
    got, want, counted, graph, dims = _both(served, B, early_exit)
    assert counted == {"step": 1, "chain": 0}
    assert graph["route"] == "step" and graph["nodes_per_step"] <= 2
    assert graph["clusters"] * graph["rows_per_cluster"] >= B
    assert got["num_steps"] == want["num_steps"]
    if not early_exit:
        assert got["num_steps"] == dims.max_output_length
    agree = (got["samples"] == want["samples"]).float().mean().item()
    assert agree >= AGREEMENT, agree
    assert not got["hidden"][:, got["num_steps"]:].any()
    same = (got["samples"] == want["samples"]).all(dim=1)
    assert torch.equal(got["attach"][same], want["attach"][same])


@pytest.mark.card
@pytest.mark.parametrize("Li,B", [(256, 32), (512, 64), (560, 64)],
                         ids=["sideface", "visible", "visible560"])
def test_step_route_at_the_other_models_buckets(served, Li, B):
    """The side-face model's bucket (its requests of up to 32 programs) and
    the visible model's (512 and 560 keys, batches of 64): the widths of
    every GQA checkpoint are ep221's, so its weights stand in for theirs."""
    got, want, counted, graph, _ = _both(served, B, True, Li=Li)
    assert counted == {"step": 1, "chain": 0}
    assert graph["clusters"] * graph["rows_per_cluster"] >= B
    assert got["num_steps"] == want["num_steps"]
    agree = (got["samples"] == want["samples"]).float().mean().item()
    assert agree >= AGREEMENT, agree
    assert not got["hidden"][:, got["num_steps"]:].any()


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 8, 64, 128, 512])
def test_bf16_takes_the_route_of_its_batch(served, B):
    """Without a forced route: the step where its plan runs in one wave of
    clusters, the chain on mma.sync past it, each with the plain version's
    tokens."""
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    got, want, counted, graph, dims = _both(served, B, True, route=None)
    plan = PD.step_plan(B, served[0](torch.bfloat16)[0].shape[1], dims)
    route = PD.route_of(torch.bfloat16, plan)
    assert route == ("step" if plan["clusters"] <= plan["held"]
                     else "chain")
    if B <= plan["held"]:  # one row a cluster fits one wave
        assert route == "step"
    assert counted == {r: int(r == route) for r in counted}
    assert graph["route"] == route
    if route == "step":
        assert (graph["rows_per_cluster"], graph["clusters"],
                graph["held"]) == (plan["rows"], plan["clusters"],
                                   plan["held"])
    assert graph["nodes_per_step"] == (1 if route == "step" else 52)
    assert got["num_steps"] == want["num_steps"]
    agree = (got["samples"] == want["samples"]).float().mean().item()
    assert agree >= AGREEMENT, agree
    assert not got["hidden"][:, got["num_steps"]:].any()


@pytest.mark.card
@pytest.mark.parametrize("B", [5, 64])
def test_step_route_on_a_ragged_mask(served, B):
    got, want, counted, _, dims = _both(served, B, False, ragged=True)
    assert counted["step"] == 1
    assert got["num_steps"] == want["num_steps"] == dims.max_output_length
    agree = (got["samples"] == want["samples"]).float().mean().item()
    assert agree >= AGREEMENT, agree
    assert not got["hidden"][:, got["num_steps"]:].any()


@pytest.mark.card
def test_f32_takes_the_chain_with_the_plain_tokens(served):
    got, want, counted, graph, _ = _both(served, 5, True, cd=torch.float32,
                                         route=None)
    assert counted == {"step": 0, "chain": 1}
    assert graph["route"] == "chain" and graph["nodes_per_step"] == 52
    assert got["num_steps"] == want["num_steps"]
    assert torch.equal(got["samples"], want["samples"])
    assert torch.equal(got["attach"], want["attach"])


# ------------------------------------------- the launch state kept per shape
ROUTES = ["step", "chain"]


def _run(served, rows, route, params=None, Li=None):
    """The CUDA decode of drawings `rows` on route `route` (bf16, early
    exit), synchronised; (its result, `last_graph`)."""
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    at, p, dims = served
    memory, mask = at(torch.bfloat16) if Li is None else at(torch.bfloat16,
                                                             Li)
    rows = torch.as_tensor(rows)
    saved = PD.route_of
    PD.route_of = lambda cd, plan: route
    try:
        got = PD.persistent_greedy_decode(
            p if params is None else params, memory[rows], mask[rows], dims,
            compute_dtype=torch.bfloat16, early_exit=True)
        torch.cuda.synchronize()
    finally:
        PD.route_of = saved
    return got, dict(PD.last_graph)


def _fresh(served, rows, route, params=None, Li=None):
    """`_run` with nothing kept from earlier calls: the decode without the
    caches, as every call built it before they existed."""
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    PD._launch_states.clear()
    PD._weights.clear()
    got, graph = _run(served, rows, route, params, Li)
    assert not graph["cached"]
    return got


def _same(got, want):
    assert got["num_steps"] == want["num_steps"]
    for k in ("samples", "attach", "hidden"):
        assert torch.equal(got[k], want[k]), k


def _copy(out):
    return {k: v.clone() if torch.is_tensor(v) else v for k, v in out.items()}


@pytest.mark.card
@pytest.mark.parametrize("route", ROUTES)
def test_a_shapes_second_call_is_a_hit_with_a_fresh_decodes_bits(served,
                                                                   route):
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    rows = list(range(5))
    want = _fresh(served, rows, route)
    hits, built = PD.graph_cache["hits"], PD.weights_cache["hits"]
    got, graph = _run(served, rows, route)
    assert graph["cached"] and graph["route"] == route
    assert PD.graph_cache["hits"] == hits + 1
    assert PD.weights_cache["hits"] == built + 1
    if route == "step":  # the kept graph takes this call's arguments
        assert graph["capture_ms"] == 0 and graph["instantiate_ms"] == 0
    _same(got, want)


@pytest.mark.card
@pytest.mark.parametrize("route", ROUTES)
def test_a_short_decode_after_a_long_one_is_a_fresh_decode(served, route):
    """One row at a time: the drawing that decodes longest, then the one
    that ends first, on the kept state; the short one's trailing tokens
    and the zero hidden columns after its steps as a fresh decode's; the
    long one's returned tensors untouched by the short call."""
    runs = {i: _fresh(served, [i], route) for i in range(0, 64, 8)}
    steps = {i: r["num_steps"] for i, r in runs.items()}
    long, short = max(steps, key=steps.get), min(steps, key=steps.get)
    assert steps[long] > steps[short]
    first, _ = _run(served, [long], route)
    kept = _copy(first)
    got, graph = _run(served, [short], route)
    assert graph["cached"]
    _same(got, runs[short])
    assert not got["hidden"][:, got["num_steps"]:].any()
    _same(first, kept)
    _same(first, runs[long])


@pytest.mark.card
@pytest.mark.parametrize("route", ROUTES)
def test_an_in_place_weight_update_is_decoded_after_it(served, route):
    """A fine-tune's validation between two steps: the weights change in
    place (the optimizer's update), the shape's graph stays, the weights
    are packed again, and the decode is a fresh one's."""
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    _, p, _ = served
    params = copy.deepcopy(p)
    rows = list(range(4))
    before = _fresh(served, rows, route, params)
    packed = PD.weights_cache["misses"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for t in (params["decoder"]["ffn"]["w1"],
                  params["heads"]["vocab"]["w"],
                  params["embed"]["value"]):
            t.add_(0.05 * t.std() * torch.randn(t.shape, generator=gen,
                                                device=t.device))
    got, graph = _run(served, rows, route, params)
    assert graph["cached"]
    assert PD.weights_cache["misses"] == packed + 1
    want = _fresh(served, rows, route, params)
    _same(got, want)
    assert not torch.equal(got["hidden"], before["hidden"])


@pytest.mark.card
@pytest.mark.parametrize("route", ROUTES)
def test_shapes_past_the_bound_are_dropped_and_built_again(served, route):
    """GRAPH_SHAPES + 1 shapes (1 to 17 rows at the side-face bucket), in
    turn and again: each past the bound drops the least recently used, so
    the second round misses every shape and still gives the first round's
    bits."""
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    PD._launch_states.clear()
    n = PD.GRAPH_SHAPES + 1
    first = {}
    for B in range(1, n + 1):
        first[B], graph = _run(served, list(range(B)), route, Li=256)
        assert not graph["cached"]
    assert len(PD._launch_states.keys()) == PD.GRAPH_SHAPES
    for B in range(1, n + 1):
        got, graph = _run(served, list(range(B)), route, Li=256)
        assert not graph["cached"], B
        _same(got, first[B])
    got, graph = _run(served, list(range(n)), route, Li=256)
    assert graph["cached"]
    _same(got, first[n])
