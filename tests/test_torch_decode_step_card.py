"""The decode's step as one launch on the card (`csrc/decode.cu`,
`step::step_kernel`, the step route of `persistent_greedy_decode`) against
the plain version `greedy_decode_reference`: ep221 on the serving drawings
at B = 1, 5 and 64, with early exit on and off, at the side-face (256 keys)
and visible (512, 560) buckets, and on a ragged mask (a row with no real
key, one with only key 0, a masked key inside a row); bf16 decodes take
the route `route_of` gives their plan (the chain on mma.sync past one wave
of clusters, B=512) with the plain version's tokens; an f32 decode takes
the chain and gives the plain version's tokens. Needs a CUDA device (skips
without one):

  python -m pytest --noconftest tests/test_torch_decode_step_card.py -q

(`--noconftest`: `tests/conftest.py` sets up JAX, which a machine with
the card need not have)
"""
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
