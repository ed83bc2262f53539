"""The PyTorch port's package boundary, configuration and checkpoints,
against the JAX package (`plankassembly_tpu_torch/`)."""
import dataclasses
import glob
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from plankassembly_tpu.config import config_from_hparams_file as jax_config
from plankassembly_tpu_torch import checkpoint as port_ckpt
from plankassembly_tpu_torch.config import (
    ModelDims, config_from_hparams_file, read_hparams_yaml,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")
HPARAMS = sorted(glob.glob(os.path.join(ROOT, "checkpoints", "*.hparams.yaml")))

_ISOLATED = r"""
import sys
for name in ("jax", "jaxlib", "yaml", "ml_dtypes", "plankassembly_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import plankassembly_tpu_torch.serving
import plankassembly_tpu_torch.metrics
import plankassembly_tpu_torch.checkpoint
import plankassembly_tpu_torch.ops.persistent_decode
import plankassembly_tpu_torch.ops.attention
import plankassembly_tpu_torch.ops.cross_decode
import plankassembly_tpu_torch.ops.fused_decode
import plankassembly_tpu_torch.beam
import plankassembly_tpu_torch.predict
import plankassembly_tpu_torch.serve
import plankassembly_tpu_torch.evaluate
import plankassembly_tpu_torch.io.svg
import plankassembly_tpu_torch.io.mesh
import plankassembly_tpu_torch.data.geometry
import plankassembly_tpu_torch.data.sideface_data
import plankassembly_tpu_torch.data.cache
import plankassembly_tpu_torch.data.device_loader
import plankassembly_tpu_torch.train.loop
import plankassembly_tpu_torch.trainer_complete
import plankassembly_tpu_torch.trainer_visible
import plankassembly_tpu_torch.trainer_sideface
import plankassembly_tpu_torch.export
import plankassembly_tpu_torch.export_serving
import plankassembly_tpu_torch.factory.native
import plankassembly_tpu_torch.data.raster
import plankassembly_tpu_torch.models.vit
import plankassembly_tpu_torch.train.raster_loop
import plankassembly_tpu_torch.trainer_raster
import plankassembly_tpu_torch.parallel.multihost
import plankassembly_tpu_torch.parallel.mesh
import plankassembly_tpu_torch.cli
import plankassembly_tpu_torch.factory
import plankassembly_tpu_torch.factory.projection
import plankassembly_tpu_torch.factory.synthetic
import plankassembly_tpu_torch.ops.boxes
import plankassembly_tpu_torch.utils.tb_writer
import plankassembly_tpu_torch.utils.profiling
import plankassembly_tpu_torch.tools.generate_models
import plankassembly_tpu_torch.tools.render_svgs
import plankassembly_tpu_torch.tools.prepare_info
import plankassembly_tpu_torch.tools.robustness_sweep
import plankassembly_tpu_torch.tools.export_checkpoint
import plankassembly_tpu_torch.tools.convert_reference_checkpoint
import plankassembly_tpu_torch.tools.build_gt_mesh
import plankassembly_tpu_torch.tools.build_pred_mesh
import plankassembly_tpu_torch.tools.build_html
import plankassembly_tpu_torch.tools.fit_chunked
import plankassembly_tpu_torch.tools.trace_summary
import plankassembly_tpu_torch.tools.leak_probe
from plankassembly_tpu_torch.config import config_from_hparams_file
cfg = config_from_hparams_file(sys.argv[1])
leaked = sorted(m for m in sys.modules if sys.modules[m] is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "yaml", "ml_dtypes")
    or m == "plankassembly_tpu" or m.startswith("plankassembly_tpu.")))
print("LEAKED", leaked)
print("KV", cfg.MODEL.NUM_KV_HEAD)
"""


def test_port_imports_without_jax_yaml_or_the_jax_package():
    """The port's entry points import with jax, yaml, ml_dtypes and the
    JAX package blocked, and load none of them."""
    out = subprocess.run(
        [sys.executable, "-c", _ISOLATED,
         os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.hparams.yaml")],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout
    assert "KV 2" in out.stdout


def test_chip_smoke_imports_nothing_of_jax():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    for banned in ("import jax", "from jax", "plankassembly_tpu.",
                   "import plankassembly_tpu\n", "import yaml",
                   "ml_dtypes"):
        assert banned not in src, banned


@pytest.mark.parametrize("path", HPARAMS, ids=os.path.basename)
def test_hparams_reader_matches_jax(path):
    """Exact equality of every field, types included (`1e-4`-style floats
    and booleans are coerced the same way)."""
    ours = dataclasses.asdict(config_from_hparams_file(path))
    ref = dataclasses.asdict(jax_config(path))
    assert ours == ref
    assert {k: type(v) for k, v in ours.items()} == \
        {k: type(v) for k, v in ref.items()}


def test_hparams_reader_scalars(tmp_path):
    p = tmp_path / "h.yaml"
    p.write_text("LR: 1e-4\nA:\n  B: true\n  C: 2.0e-05\n  D: relu\n"
                 "  E: -3\nF: 'x y'\n")
    assert read_hparams_yaml(str(p)) == {
        "LR": 1e-4, "A": {"B": True, "C": 2e-5, "D": "relu", "E": -3},
        "F": "x y"}
    p.write_text("A:\n  - 1\n")
    with pytest.raises(ValueError):
        read_hparams_yaml(str(p))


def test_load_npz_bit_exact_against_ml_dtypes():
    """Every array of ep221 decodes to the same float32 bits as the JAX
    package's ml_dtypes path (`tools/predict.py:38-49`)."""
    ours = port_ckpt.load_npz(CKPT)
    n = 0
    with np.load(CKPT) as z:
        assert len(z.files) == 60  # 59 parameter arrays + __step__
        for key in z.files:
            if key == "__step__":
                continue
            ref = z[key].view(ml_dtypes.bfloat16).astype(np.float32)
            node = ours
            for part in key.split("/"):
                node = node[part]
            assert node.dtype == torch.bfloat16
            np.testing.assert_array_equal(node.float().numpy().view(np.uint32),
                                          ref.view(np.uint32))
            n += 1
    assert n == 59


def test_params_from_jax_round_trip():
    from plankassembly_tpu.models.model import (
        ModelDims as JaxDims, init_params,
    )
    import jax
    from tests.tiny import tiny_config
    params = init_params(jax.random.PRNGKey(0),
                         JaxDims.from_config(tiny_config()))
    tree = jax.tree.map(np.asarray, params)
    back = port_ckpt.params_to_numpy(port_ckpt.params_from_jax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        np.testing.assert_array_equal(flat_b[path], a)


def test_model_dims_match_jax():
    from plankassembly_tpu.models.model import ModelDims as JaxDims
    for path in HPARAMS:
        ours = ModelDims.from_config(config_from_hparams_file(path))
        ref = JaxDims.from_config(jax_config(path))
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert (ours.kv_heads, ours.kv_groups, ours.head_dim) == \
            (ref.kv_heads, ref.kv_groups, ref.head_dim)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """Called without `device`, entry points ask for the GPU and raise
    when CUDA is absent instead of running on the CPU."""
    from plankassembly_tpu_torch.serving import make_live_backend
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_from_hparams_file(HPARAMS[0])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_ckpt.load_checkpoint(CKPT)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_live_backend({}, cfg, batch=4, bucket=128)


def test_tokens_match_jax():
    from plankassembly_tpu import tokens as jt
    from plankassembly_tpu_torch import tokens as pt
    v = np.random.default_rng(0).uniform(-1, 1, 1000)
    np.testing.assert_array_equal(pt.quantize_values(v), jt.quantize_values(v))
    q = np.arange(512)
    np.testing.assert_array_equal(pt.dequantize_values(q),
                                  jt.dequantize_values(q))
    assert (pt.END, pt.PAD, pt.VOCAB_SIZE) == (jt.END, jt.PAD, jt.VOCAB_SIZE)
