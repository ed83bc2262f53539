"""Tests of the benchmark harness. On the CPU they drive whole runs of each
cell at a tiny width (the program's plain versions); the tests marked
`card` run the real cells and skip where no CUDA device is present.

  python -m pytest bench_port/tests -q
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

BASE_HPARAMS = {
    "gqa_complete_ep221": "checkpoints/gqa_complete_ep221.hparams.yaml",
    "gqa_visible_ep79": "checkpoints/gqa_visible_ep79.hparams.yaml",
}
TINY = {"NUM_MODEL: 512": "NUM_MODEL: 32", "NUM_HEAD: 8": "NUM_HEAD: 4",
        "NUM_FEEDFORWARD: 1024": "NUM_FEEDFORWARD: 64",
        "NUM_ENCODER_LAYERS: 6": "NUM_ENCODER_LAYERS: 1",
        "NUM_DECODER_LAYERS: 6": "NUM_DECODER_LAYERS: 1"}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, never while
    the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cell runs on the card only")


def make_tiny(directory, config_name, seed=0, head_scale=1.0):
    """A tiny checkpoint of the configuration's layout (d=32, 4/2 heads,
    1+1 layers, random weights; the vocab head's weights times
    `head_scale`) and the config keys that point at it."""
    import torch
    from plankassembly_tpu_torch.config import (
        ModelDims, config_from_hparams_file, read_hparams_yaml,
    )
    from plankassembly_tpu_torch.models.model import init_params

    text = open(os.path.join(ROOT, BASE_HPARAMS[config_name])).read()
    for a, b in TINY.items():
        text = text.replace(a, b)
    hp = os.path.join(directory, f"{config_name}.hparams.yaml")
    npz = os.path.join(directory, f"{config_name}.x{head_scale:g}.npz")
    with open(hp, "w") as f:
        f.write(text)
    cfg = config_from_hparams_file(hp)
    params = init_params(torch.Generator().manual_seed(seed),
                         ModelDims.from_config(cfg))
    params["heads"]["vocab"]["w"] *= head_scale
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = v.to(torch.bfloat16).view(
                    torch.int16).numpy().view(np.dtype("V2"))
    walk(params, "")
    np.savez(npz, **flat)
    raw = read_hparams_yaml(hp)
    return {"checkpoint": npz, "hparams": hp, "MODEL": raw["MODEL"],
            "DATA": raw["DATA"], "TOKEN": raw["TOKEN"]}


# small traffic for CPU runs of each kind
TINY_TRAFFIC = {
    "offline": {"job": 128},
}


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("tiny")
    return {name: make_tiny(str(d), name) for name in BASE_HPARAMS}


@pytest.fixture(scope="session")
def sharp(tmp_path_factory):
    """Tiny models whose vocab head is 8 times its random init: peaked
    next-token distributions, as a trained model's are, so that rounding
    that flips a choice costs what it costs a trained model."""
    d = tmp_path_factory.mktemp("sharp")
    return {name: make_tiny(str(d), name, head_scale=8.0)
            for name in BASE_HPARAMS}


def run_tiny(tiny, workload, trace=0, seconds=1.0, seed=2 ** 31 + 17,
             control=False):
    """One CPU run of `workload` at the tiny size: (result, checks, ctx)."""
    import torch
    from bench_port.harness import cell
    torch.set_num_threads(2)
    bench = cell.load_json(ROOT, "BENCHMARK.json")
    w = next(x for x in bench["workloads"] if x["name"] == workload)
    kind = cell.load_json(ROOT, "bench_port", "traffic",
                          w["traffic"] + ".json")["kind"]
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds,
                              trace=trace)
    return cell.run(args, time.monotonic(), device="cpu", control=control,
                    override={"config": tiny[w["config"]],
                              "traffic": TINY_TRAFFIC[kind]})
