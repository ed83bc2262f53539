"""The plain reference agrees with the program's plain CPU path at a tiny
width, and packs every pool drawing as the program does."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port.harness import check as C
from bench_port.harness import pool as P
from bench_port.reference.model import Reference, load_npz
from conftest import ROOT


@pytest.mark.parametrize("config", ["gqa_complete_ep221", "gqa_visible_ep79"])
def test_packing_matches_program(config):
    from bench_port.harness.cell import load_json
    from plankassembly_tpu_torch.config import config_from_hparams_file
    from plankassembly_tpu_torch.serving import pack_info_dict
    conf = load_json(ROOT, "bench_port", "configs", config + ".json")
    cfg = config_from_hparams_file(f"{ROOT}/{conf['hparams']}")
    for body in P.requests(conf):
        got = pack_info_dict(body, cfg)
        want = C.pack_request(body, conf)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_reference_follows_program_decode(tiny):
    """Teacher forced on the program's own f32 greedy tokens, the
    reference puts each served candidate first (gap 0 to rounding)."""
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.decode import greedy_decode
    from plankassembly_tpu_torch.serving import pack_info_dict
    conf = tiny["gqa_complete_ep221"]
    params, cfg = load_checkpoint(conf["checkpoint"], conf["hparams"],
                                  device="cpu")
    dims = ModelDims.from_config(cfg)
    bodies = P.requests()[:6]
    packed = [pack_info_dict(b, cfg) for b in bodies]
    inputs = {k: torch.from_numpy(np.stack([p[k] for p in packed]))
              for k in packed[0]}
    out = greedy_decode(params, inputs, dims, compute_dtype=torch.float32,
                        kv_quant=False, cross_impl="xla")
    items = [{"body": b, "packed": p, "tokens": out["samples"][i].numpy(),
              "attach": out["attach"][i].numpy(),
              "answer": C.RP.postprocess(out["samples"][i].numpy(),
                                         out["attach"][i].numpy(),
                                         dims.end, dims.num_output_dof)}
             for i, (b, p) in enumerate(zip(bodies, packed))]
    r, _ = C.judge(items, conf, ROOT, "cpu")
    assert r["pack_mismatches"] == r["answer_mismatches"] == 0
    assert r["pointer_faults"] == 0
    assert r["max_gap"] < 1e-4
    assert r["tokens"] > 6 * 6


def test_reference_loader_reads_bf16_exactly(tiny):
    from plankassembly_tpu_torch.checkpoint import load_npz as prog_load
    w = load_npz(tiny["gqa_complete_ep221"]["checkpoint"], "cpu")
    prog = prog_load(tiny["gqa_complete_ep221"]["checkpoint"])
    assert torch.equal(w["decoder/ffn/w1"],
                       prog["decoder"]["ffn"]["w1"].float())
    ref = Reference(w, tiny["gqa_complete_ep221"]["MODEL"],
                    tiny["gqa_complete_ep221"]["DATA"],
                    tiny["gqa_complete_ep221"]["TOKEN"])
    assert ref.kvH == 2 and ref.Dh == 8
