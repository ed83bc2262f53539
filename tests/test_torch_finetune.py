"""Long training runs of the port against the JAX package, on the CPU at a
tiny width: `Trainer.fit` over 3 epochs of 8 steps (the fine-tune
protocol's shape: `tests/make_torch_finetune_golden.py`), resume from
`last`, the chunked fit tool against JAX's resume run chunk by chunk,
the visible modality's `test`, the host RSS in the metrics stream, and the
trace reader and leak probe. The full-width fine-tune against the JAX
golden is `-m slow` here and runs in full on the card (`chip_smoke.py`
finetune)."""
import glob
import gzip
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plankassembly_tpu.config import load_config as jax_load_config
from plankassembly_tpu.train import Trainer as JaxTrainer
from plankassembly_tpu.train import VisibleTrainer as JaxVisibleTrainer
from plankassembly_tpu_torch.checkpoint import params_from_jax
from plankassembly_tpu_torch.config import load_config
from plankassembly_tpu_torch.tools import fit_chunked, leak_probe
from plankassembly_tpu_torch.tools import trace_summary
from plankassembly_tpu_torch.train.loop import Trainer, VisibleTrainer
from plankassembly_tpu_torch.train.state import tree_leaves
from plankassembly_tpu_torch.utils.profiling import annotate, trace_context
from plankassembly_tpu_torch.utils.tb_writer import read_tfevents
from tests.tiny import write_tiny_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 7
EPOCHS = 3
# The two packages' losses step by step, f32, dropout 0, augmentation on.
# One step agrees to float32 order (~1e-7 relative, `test_torch_parity`'s
# 3e-5 absolute); Adam then divides each moment by the root of its square,
# so a gradient that differs in its last bits moves a weight by that share
# of the learning rate, and the runs part like a random walk of such
# steps. Measured here over the 24 steps (`test_fit_matches_jax`
# prints the curve): the largest relative difference of a step's loss grows
# from ~1e-7 at step 1 to ~1e-5 by step 24 at lr 1e-3, two decades inside
# this bar, which is the parity tests' loss tolerance.
LOSS_ATOL = 3e-5
F1_TOL = 1e-6          # same programs: the F1 of identical decodes

TINY_YAML = """seed_everything: {seed}
trainer:
  max_epochs: {epochs}
  check_val_every_n_epoch: 1
  log_every_n_steps: 1
  default_root_dir: {log_root}
  decode_impl: xla
  accelerator: cpu
model:
  hparams:
    ROOT: {root}/infos
    DATASETS_TRAIN: {root}/train.txt
    DATASETS_VALID: {root}/valid.txt
    DATASETS_TEST: {root}/test.txt
    BATCH_SIZE: 2
    NUM_WORKERS: 0
    LR: 1e-3
    DATA:
      MAX_INPUT_LENGTH: 320
      MAX_OUTPUT_LENGTH: 48
      AUG_RATIO: 0.5
    MODEL:
      NUM_MODEL: 16
      NUM_HEAD: 2
      NUM_KV_HEAD: 1
      NUM_FEEDFORWARD: 32
      NUM_ENCODER_LAYERS: 1
      NUM_DECODER_LAYERS: 1
      DROPOUT: 0.0
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(dataset root, config YAML, JAX init params as numpy, their npz):
    16 training drawings, 8 steps an epoch at B=2, and 4 of them
    validate."""
    base = tmp_path_factory.mktemp("finetune")
    root = base / "data"
    names = write_tiny_dataset(str(root), n_samples=16)
    for split in ("valid", "test"):  # 4 drawings validate, 16 train
        (root / f"{split}.txt").write_text("".join(
            f"{n}.json\n" for n in names[:4]))
    cfg_path = base / "tiny.yaml"
    cfg_path.write_text(TINY_YAML.format(seed=SEED, epochs=EPOCHS,
                                         log_root=base / "runs", root=root))
    jcfg = jax_load_config(str(cfg_path))
    jtrainer = JaxTrainer(jcfg, log_dir=str(base / "init"),
                          compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jtrainer.init_state().params)
    flat = {"/".join(p): t.numpy()
            for p, t in tree_leaves(params_from_jax(params))}
    npz = base / "init.npz"
    np.savez(npz, **flat)
    return {"base": base, "root": root, "yaml": str(cfg_path),
            "params": params, "npz": str(npz)}


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return ([r for r in recs if "train/loss" in r],
            [r for r in recs if "val/fmeasure" in r])


def _meta(log_dir, tag):
    with open(os.path.join(log_dir, "checkpoints", f"{tag}.meta.json")) as f:
        return json.load(f)


def _jax_fit(tiny, log_dir, state=None, max_epochs=None, ckpt=None):
    """JAX's fit as a fresh process runs it: numpy's global RNG seeded
    with seed_everything (the reference's Lightning seeding), a new
    trainer, from `ckpt` or `state` or the init."""
    np.random.seed(SEED)
    trainer = JaxTrainer(jax_load_config(tiny["yaml"]), log_dir=log_dir,
                         compute_dtype=jnp.float32)
    if ckpt is not None:
        state = trainer.load_checkpoint(ckpt)
    elif state is None:
        state = trainer.init_state()
    return trainer, trainer.fit(state, max_epochs=max_epochs)


def _port_trainer(tiny, log_dir, cls=Trainer):
    return cls(load_config(tiny["yaml"]), log_dir=log_dir,
               compute_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def runs(tiny):
    """The monolithic 3-epoch fit of each package from the same init."""
    base = tiny["base"]
    jtrainer, jstate = _jax_fit(tiny, str(base / "jax_mono"))
    trainer = _port_trainer(tiny, str(base / "port_mono"))
    state = trainer.fit(trainer._state(params_from_jax(tiny["params"])))
    trainer.close()
    return {"jax": (jtrainer, jstate), "port": (trainer, state)}


def _assert_losses(ours, ref):
    assert [r["step"] for r in ours] == [r["step"] for r in ref]
    assert [r["epoch"] for r in ours] == [r["epoch"] for r in ref]
    np.testing.assert_allclose([r["train/loss"] for r in ours],
                               [r["train/loss"] for r in ref],
                               atol=LOSS_ATOL)
    np.testing.assert_allclose([r["train/accuracy"] for r in ours],
                               [r["train/accuracy"] for r in ref], atol=1e-6)


def _assert_vals(ours, ref):
    assert [(r["step"], r["epoch"]) for r in ours] == \
        [(r["step"], r["epoch"]) for r in ref]
    for key in ("val/precision", "val/recall", "val/fmeasure"):
        np.testing.assert_allclose([r[key] for r in ours],
                                   [r[key] for r in ref], atol=F1_TOL)


def test_fit_matches_jax(runs):
    """Every step's loss and accuracy, every validation, and the best and
    last checkpoints' meta of the port's fit equal JAX's, with augmented
    rows in the batches (AUG_RATIO 0.5, the rows JAX draws from numpy's
    global RNG)."""
    jtrainer, jstate = runs["jax"]
    trainer, state = runs["port"]
    jsteps, jvals = _records(jtrainer.log_dir)
    steps, vals = _records(trainer.log_dir)
    assert len(steps) == EPOCHS * 8 == state.step == int(jstate.step)
    rel = [abs(a["train/loss"] - b["train/loss"]) / b["train/loss"]
           for a, b in zip(steps, jsteps)]
    print("loss drift, relative, steps 1-24: "
          + " ".join(f"{x:.1e}" for x in rel))
    _assert_losses(steps, jsteps)
    _assert_vals(vals, jvals)
    for tag in ("best", "last"):
        ours, ref = _meta(trainer.log_dir, tag), _meta(jtrainer.log_dir, tag)
        assert (ours["epoch"], ours["step"]) == (ref["epoch"], ref["step"])
        assert sorted(ours["metrics"]) == sorted(ref["metrics"])
        for k, v in ref["metrics"].items():
            assert ours["metrics"][k] == pytest.approx(v, abs=F1_TOL)


def test_host_rss_in_the_stream(runs):
    """Every logged step carries host_rss_mb, in metrics.jsonl and in the
    tfevents stream, as JAX's loop logs it; JAX's tools/summarize_run.py
    prints the port's run as it prints JAX's (the same validation lines,
    an RSS line)."""
    jtrainer, _ = runs["jax"]
    trainer, _ = runs["port"]
    steps, _ = _records(trainer.log_dir)
    assert all(isinstance(r["host_rss_mb"], int) and r["host_rss_mb"] > 0
               for r in steps)
    (path,) = glob.glob(os.path.join(trainer.log_dir, "events.out.*"))
    rss = {e["step"]: e["scalars"]["host_rss_mb"] for e in read_tfevents(path)
           if "host_rss_mb" in e.get("scalars", {})}
    assert rss == {r["step"]: float(r["host_rss_mb"]) for r in steps}

    def summary(run):
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "summarize_run.py"),
             run], capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.splitlines()[1:]

    ours, ref = summary(trainer.log_dir), summary(jtrainer.log_dir)
    assert len(ours) == len(ref) == EPOCHS + 1
    assert ours[:EPOCHS] == ref[:EPOCHS]
    assert "rss" in ours[-1] and "- ->" not in ours[-1]


def _state_tensors(state):
    opt = state.optimizer.state_dict()["state"]
    return ([t.detach() for _, t in tree_leaves(state.params)],
            [(s["step"], s["exp_avg"], s["exp_avg_sq"])
             for _, s in sorted(opt.items())])


def test_resume_from_last_matches_jax(tiny, runs):
    """`load_checkpoint(last)` restores the parameters, the Adam moments
    and the step bit for bit, in both packages; one more epoch from there
    continues the step counter, restarts the epoch counter at 0 and draws
    the loader anew, in both alike."""
    base = tiny["base"]
    jtrainer, jstate = runs["jax"]
    trainer, state = runs["port"]
    last = os.path.join(trainer.log_dir, "checkpoints", "last")
    resumed = _port_trainer(tiny, str(base / "port_resume"))
    restored = resumed.load_checkpoint(last)
    assert restored.step == state.step == EPOCHS * 8
    (p0, m0), (p1, m1) = _state_tensors(state), _state_tensors(restored)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert len(m0) == len(m1) == len(p0)
    for a, b in zip(m0, m1):
        assert all(torch.equal(torch.as_tensor(x), torch.as_tensor(y))
                   for x, y in zip(a, b))
    resumed.fit(restored, max_epochs=1)
    resumed.close()

    jlast = os.path.join(jtrainer.log_dir, "checkpoints", "last")
    jresumed, _ = _jax_fit(tiny, str(base / "jax_resume"), max_epochs=1,
                           ckpt=jlast)
    jrestored = jresumed.load_checkpoint(jlast)
    assert int(jrestored.step) == int(jstate.step)
    for a, b in zip(jax.tree.leaves(jrestored.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    steps, vals = _records(resumed.log_dir)
    jsteps, jvals = _records(jresumed.log_dir)
    assert [r["step"] for r in steps] == list(range(25, 33))
    assert {r["epoch"] for r in steps} == {0}
    _assert_losses(steps, jsteps)
    _assert_vals(vals, jvals)


def test_fit_chunked_matches_jax_chunk_by_chunk(tiny):
    """The port's chunked fit, 3 chunks of 1 epoch, each a fresh process
    on the CPU that resumes from the previous chunk's `last`, against
    JAX's resume run in one process: fit, load_checkpoint(last), fit, ...
    with the RNG seeded per chunk as a fresh process seeds it."""
    base = tiny["base"]
    final = fit_chunked.main([
        "--trainer", "complete", "--config", tiny["yaml"],
        "--total-epochs", "3", "--epochs-per-chunk", "1",
        "--root-dir", str(base / "chunked"), "--ckpt_path", tiny["npz"],
        "--", "--device", "cpu", "--precision", "f32"])
    runs = sorted(glob.glob(str(base / "chunked" / "version_*")))
    assert len(runs) == 3
    assert final == os.path.join(runs[-1], "checkpoints", "last")
    ckpt = None
    for k, run in enumerate(runs):
        jtrainer, _ = _jax_fit(tiny, str(base / f"jax_chunk{k}"),
                               max_epochs=1, ckpt=ckpt,
                               state=None)
        ckpt = os.path.join(jtrainer.log_dir, "checkpoints", "last")
        steps, vals = _records(run)
        jsteps, jvals = _records(jtrainer.log_dir)
        assert [r["step"] for r in steps] == list(range(8 * k + 1,
                                                        8 * k + 9))
        _assert_losses(steps, jsteps)
        _assert_vals(vals, jvals)
        assert _meta(run, "last")["step"] == 8 * (k + 1)
    restored = _port_trainer(tiny, str(base / "chunked_load")) \
        .load_checkpoint(final)
    assert restored.step == 24


def test_released_npz_keeps_its_step(tiny, tmp_path):
    """A released npz's `__step__` is the step a fit from it continues
    (JAX's `tools/export_checkpoint.py import` keeps it: ep221's fine-tune
    logs steps 65001..65024 in the golden), with a fresh Adam state."""
    with np.load(tiny["npz"]) as z:
        flat = dict(z)
    npz = tmp_path / "released.npz"
    np.savez(npz, __step__=np.asarray(65000), **flat)
    trainer = _port_trainer(tiny, str(tmp_path / "run"))
    state = trainer.load_checkpoint(str(npz))
    assert state.step == 65000 and not state.optimizer.state_dict()["state"]
    trainer.fit(state, max_epochs=1)
    trainer.close()
    steps, vals = _records(trainer.log_dir)
    assert [r["step"] for r in steps] == list(range(65001, 65009))
    assert _meta(trainer.log_dir, "last")["step"] == 65008
    golden = np.load(os.path.join(ROOT, "plankassembly_tpu_torch",
                                  "fixtures", "finetune_jax_golden.npz"))
    assert int(golden["import_step"]) == 65000
    assert golden["step"][0] == 65001 and golden["last_step"] == 65024


def test_failing_chunk_stops_the_run(tiny, tmp_path):
    """A chunk that exits non-zero, or that writes no `last`, stops the
    run with a non-zero exit before the next chunk."""
    args = ["--config", tiny["yaml"], "--total-epochs", "2",
            "--epochs-per-chunk", "1", "--root-dir", str(tmp_path),
            "--ckpt_path", tiny["npz"], "--", "--device", "cpu"]
    with pytest.raises(SystemExit, match="chunk 0 failed with rc=1"):
        fit_chunked.main(args + ["--model.hparams.NO_SUCH_KEY", "1"])
    with pytest.raises(SystemExit, match="wrote no 'last'"):
        fit_chunked.main(args + ["--trainer.save_last", "false",
                                 "--trainer.check_val_every_n_epoch", "5"])
    assert len(glob.glob(str(tmp_path / "version_*"))) == 1


def test_chip_smoke_defines_each_name_once():
    """chip_smoke.py grows a phase a slice: a helper of a new phase that
    reuses an older helper's name would replace it for every phase."""
    import ast
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign)
              for t in n.targets if isinstance(t, ast.Name)]
    assert len(names) > 100
    assert sorted({n for n in names if names.count(n) > 1}) == []


def _event(name, cat, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid, "args": args}


def test_trace_summary_busy_time_is_the_union(tmp_path, capsys):
    """Kernels that overlap on two streams count once in the busy time;
    the table sums each kernel's own time; --filter keeps the kernels
    launched inside an annotate range, from any thread of the process."""
    events = [
        _event("step", "user_annotation", 0, 100),
        _event("cudaLaunchKernel", "cuda_runtime", 10, 2, correlation=1),
        _event("cudaLaunchKernel", "cuda_runtime", 20, 2, correlation=2),
        _event("cudaLaunchKernel", "cuda_runtime", 150, 2, correlation=3),
        _event("attn", "kernel", 100, 50, pid=0, tid=7, correlation=1),
        _event("gemm", "kernel", 120, 50, pid=0, tid=8, correlation=2),
        _event("attn", "kernel", 200, 10, pid=0, tid=7, correlation=3),
        # a backward's launch from autograd's own thread, inside the range
        _event("cudaLaunchKernel", "cuda_runtime", 40, 2, tid=2,
               correlation=4),
        _event("dq", "kernel", 215, 5, pid=0, tid=7, correlation=4),
        _event("aten::mm", "cpu_op", 30, 5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = trace_summary.main([str(tmp_path), "--gaps"])
    assert out["kind"] == "device" and out["path"] == str(path)
    assert [(n, us, c) for n, us, c, _ in out["top"]] == [
        ("attn", 60, 2), ("gemm", 50, 1), ("dq", 5, 1)]
    assert out["busy_us"] == 85 and out["span_us"] == 120
    assert out["gaps"] == [(30, "gemm", "attn"), (5, "attn", "dq")]
    assert "70.8%" in capsys.readouterr().out
    only = trace_summary.main([str(path), "--filter", "step"])
    assert [(n, us, c) for n, us, c, _ in only["top"]] == [
        ("attn", 50, 1), ("gemm", 50, 1), ("dq", 5, 1)]


def test_trace_summary_reads_a_trace_context_trace(tmp_path):
    """A CPU trace of `trace_context` has no device events: the reader
    lists its host operators, and --filter those under an annotation."""
    a, b = torch.ones(32, 32), torch.ones(32, 32)
    with trace_context(str(tmp_path)):
        with annotate("plank-step"):
            (a @ b).sum()
        torch.relu(a)
    out = trace_summary.main([str(tmp_path), "--gaps"])
    names = [r[0] for r in out["top"]]
    assert out["kind"] == "host" and "aten::mm" in names \
        and "aten::relu" in names
    assert 0 < out["busy_us"] <= out["span_us"]
    only = [r[0] for r in trace_summary.main(
        [str(tmp_path), "--filter", "plank-step"])["top"]]
    assert "aten::mm" in only and "aten::relu" not in only


def test_leak_probe_stages_on_the_cpu(tmp_path, capsys):
    """Each stage prints one JSON line with its RSS slope; a tiny model on
    the CPU."""
    cfg = tmp_path / "tiny_raster.yaml"
    cfg.write_text("model:\n  hparams:\n    MODEL:\n      NUM_MODEL: 16\n"
                   "      NUM_HEAD: 2\n      NUM_FEEDFORWARD: 32\n"
                   "      NUM_ENCODER_LAYERS: 1\n      NUM_DECODER_LAYERS: 1\n")
    out = leak_probe.main(["--iters", "5", "--batch", "2", "--image-size",
                           "64", "--patch-size", "16", "--config", str(cfg),
                           "--device", "cpu"])
    assert [r["stage"] for r in out] == ["dataset", "put", "step", "full"]
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines == out
    assert all(r["rss_mb"] > 0 and r["device"] == "cpu" for r in out)


def test_visible_trainer_test_matches_jax(tiny, tmp_path):
    """`VisibleTrainer.test` of the same parameters: the same P/R/F1 and
    the same prediction JSONs as JAX's, f32."""
    jtrainer = JaxVisibleTrainer(jax_load_config(tiny["yaml"]),
                                 log_dir=str(tmp_path / "jax"),
                                 compute_dtype=jnp.float32)
    jscores = jtrainer.test(jtrainer.init_state())
    trainer = _port_trainer(tiny, str(tmp_path / "port"), VisibleTrainer)
    scores = trainer.test(trainer._state(params_from_jax(tiny["params"])))
    trainer.close()
    np.testing.assert_allclose(scores, jscores, atol=F1_TOL)
    for path in sorted(glob.glob(str(tmp_path / "jax" / "pred_jsons" /
                                     "*.json"))):
        with open(path) as f:
            ref = json.load(f)
        with open(str(tmp_path / "port" / "pred_jsons" /
                      os.path.basename(path))) as f:
            ours = json.load(f)
        assert ours["prediction"] == ref["prediction"]
        assert ours["attach"] == ref["attach"]
        assert ours["fmeasure"] == pytest.approx(ref["fmeasure"], abs=F1_TOL)


@pytest.mark.slow
def test_full_width_finetune_first_steps_match_the_golden(tmp_path):
    """The port's fine-tune of ep221 through the CLI, on the CPU, f32: its
    first epoch (8 steps) against `fixtures/finetune_jax_golden.npz` at
    the protocol's f32 bars (the whole run is chip_smoke.py's finetune
    phase)."""
    golden = np.load(os.path.join(ROOT, "plankassembly_tpu_torch",
                                  "fixtures", "finetune_jax_golden.npz"))
    fixtures = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
    splits = {}
    for split, name in (("train", "train64.json.gz"),
                        ("valid", "serve64.json.gz")):
        with gzip.open(os.path.join(fixtures, name), "rt") as f:
            infos = json.load(f)
        os.makedirs(tmp_path / "infos", exist_ok=True)
        for info in infos:
            (tmp_path / "infos" / f"{info['name']}.json").write_text(
                json.dumps(info))
        splits[split] = tmp_path / f"{split}.txt"
        splits[split].write_text("".join(f"{i['name']}.json\n"
                                         for i in infos))
    # one epoch of the protocol (8 steps), no validation
    overrides = dict(o.split("=", 1) for o in golden["overrides"])
    overrides.update({"trainer.max_epochs": "1",
                      "trainer.check_val_every_n_epoch": "2",
                      "trainer.save_last": "false"})
    argv = ["fit", "--config", os.path.join(ROOT, "configs",
                                            "train_synthetic_gqa.yaml"),
            "--ckpt_path", os.path.join(ROOT, "checkpoints",
                                        "gqa_complete_ep221.npz"),
            "--device", "cpu", "--precision", "f32",
            "--model.hparams.ROOT", str(tmp_path / "infos"),
            "--model.hparams.DATASETS_TRAIN", str(splits["train"]),
            "--model.hparams.DATASETS_VALID", str(splits["valid"]),
            "--trainer.default_root_dir", str(tmp_path / "runs")]
    for k, v in overrides.items():
        argv += [f"--{k}", v]
    from plankassembly_tpu_torch import cli
    trainer, _ = cli.main(argv)
    steps, _ = _records(trainer.log_dir)
    assert [r["step"] for r in steps] == list(golden["step"][:8])
    loss = np.array([r["train/loss"] for r in steps])
    rel = np.abs(loss - golden["loss"][:8]) / golden["loss"][:8]
    print("full-width loss drift, relative, steps 1-8: "
          + " ".join(f"{x:.1e}" for x in rel))
    assert rel[0] <= 1e-4 and rel.max() <= 1e-3, rel
