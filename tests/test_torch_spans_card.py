"""The program's spans on the card: the persistent decode's three phases
lie in order inside their `decode_from_memory`, a shape's first call
building its graph and its later calls finding it (`cached`), and a CUDA
trace of `trace_context` carries the spans on its host clock, with no
device activity under a span's name. Needs a CUDA device (skips without one):

  python -m pytest --noconftest tests/test_torch_spans_card.py -q

(`--noconftest`: `tests/conftest.py` sets up JAX, which a machine with
the card need not have)
"""
import dataclasses
import glob
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from plankassembly_tpu_torch import decode as D
from plankassembly_tpu_torch.config import Config, ModelDims
from plankassembly_tpu_torch.models.model import init_params
from plankassembly_tpu_torch.ops import persistent_decode as PD
from plankassembly_tpu_torch.tools import trace_summary
from plankassembly_tpu_torch.utils import profiling as P

PHASES = ["persistent.prepare", "persistent.graph_build",
          "persistent.replay"]


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never while
    the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the persistent decode runs on the card "
                    "only")
    P.clear()
    yield torch.device("cuda")
    P.clear()


def _model(device, rows=4, width=64):
    """A small grouped-query model of the widths the CUDA decode takes
    (d 128, 2/1 heads, FFN 128, 1+1 layers, random weights) and `rows`
    random drawings of `width` tokens, a few of them pads."""
    cfg = Config()
    cfg = dataclasses.replace(
        cfg, DATA=dataclasses.replace(cfg.DATA, MAX_INPUT_LENGTH=width,
                                      MAX_OUTPUT_LENGTH=24),
        MODEL=dataclasses.replace(cfg.MODEL, NUM_MODEL=128, NUM_HEAD=2,
                                  NUM_KV_HEAD=1, NUM_FEEDFORWARD=128,
                                  NUM_ENCODER_LAYERS=1,
                                  NUM_DECODER_LAYERS=1))
    dims = ModelDims.from_config(cfg)
    gen = torch.Generator().manual_seed(0)

    def to(tree):
        return {k: to(v) if isinstance(v, dict) else v.to(device)
                for k, v in tree.items()}

    params = to(init_params(gen, dims))
    real = width - 8
    value = torch.randint(0, 512, (rows, width), generator=gen)
    value[:, real] = dims.end
    value[:, real + 1:] = dims.pad
    batch = {
        "input_value": value,
        "input_pos": torch.randint(0, dims.max_num_input, (rows, width),
                                   generator=gen),
        "input_coord": torch.arange(width).remainder(4).expand(rows, width),
        "input_view": torch.randint(0, 3, (rows, width), generator=gen),
        "input_type": torch.randint(0, 2, (rows, width), generator=gen),
        "input_mask": value == dims.pad,
    }
    return params, {k: v.to(device) for k, v in batch.items()}, dims


def _decode(params, batch, dims):
    return D.greedy_decode(params, batch, dims, compute_dtype=torch.bfloat16,
                           kv_quant=True, cross_impl="persistent")


@pytest.mark.card
@pytest.mark.parametrize("cached", [False, True], ids=["miss", "hit"])
def test_persistent_phases_in_order_inside_their_decode(card, cached):
    params, batch, dims = _model(card)
    _decode(params, batch, dims)        # builds the kernels, untraced
    torch.cuda.synchronize()
    if not cached:
        PD._launch_states.clear()
    assert P.spans() == []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = _decode(params, batch, dims)
    spans = P.spans()
    (dec,) = [s for s in spans if s.name == "decode_from_memory"]
    assert dec.attrs == {"cross_impl": "persistent"}
    phases = [s for s in spans if s.name in PHASES]
    assert [s.name for s in phases] == PHASES
    assert all(s.parent == dec.id and s.root == dec.root for s in phases)
    bounds = [dec.t0] + [t for s in phases for t in (s.t0, s.t1)] + [dec.t1]
    assert bounds == sorted(bounds)
    # the structure mask is on the device: no copy waits in the set-up
    assert not [s for s in spans if s.name == "persistent.mask_copy"]
    replay = phases[2]
    assert replay.attrs["steps"] == out["num_steps"] > 0
    assert replay.attrs["replays"] >= 1 and replay.attrs["device_ms"] > 0
    assert phases[1].attrs["nodes_per_step"] > 0
    assert phases[1].attrs["cached"] == cached == PD.last_graph["cached"]
    assert PD.last_graph["replays"] == replay.attrs["replays"]
    assert PD.last_graph["replay_ms"] == replay.attrs["device_ms"]
    if not cached:
        assert PD.last_graph["capture_ms"] > 0 \
            and PD.last_graph["instantiate_ms"] > 0
    elif PD.last_graph["route"] == "step":  # its graph takes new arguments
        assert PD.last_graph["capture_ms"] == 0 \
            and PD.last_graph["instantiate_ms"] == 0


@pytest.mark.card
def test_cuda_trace_carries_the_spans_and_no_device_span(card, tmp_path):
    params, batch, dims = _model(card)
    _decode(params, batch, dims)
    torch.cuda.synchronize()
    with P.trace_context(str(tmp_path)):
        with P.annotate("plank-batch"):
            _decode(params, batch, dims)
            torch.cuda.synchronize()
    (path,) = glob.glob(os.path.join(tmp_path, "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ours = {e["name"] for e in events if "span" in e.get("args", {})}
    assert {"plank-batch", "greedy_decode", "encode",
            "decode_from_memory"} | set(PHASES) <= ours
    device = [e for e in events if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")]
    assert device and not {e["name"] for e in device} & ours
    # the kernels launched inside the span, on the trace's clock
    under = trace_summary.main([path, "--filter", "plank-batch"])
    assert under["kind"] == "device" and under["top"]
