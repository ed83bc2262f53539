"""The port's multi-process trainer on the CPU (gloo), the analog of
`tests/test_multihost.py`: a 2-process fit, validation and test of the
tiny model on the 8 shortest drawings of the training fixture against the
1-process run of the same global batch, a tensor-parallel checkpoint
reloaded on one device, a data-parallel serving artifact, and the process
group formed from the PLANK_* variables.

One spawn of 2 worker processes (`tests/torch_dist_worker.py`) forms its
worlds in turn, each through a `file://` rendezvous under the test's
directory.
"""
import dataclasses
import gzip
import json
import os

import numpy as np
import pytest
import torch

from plankassembly_tpu_torch.config import write_hparams_yaml
from plankassembly_tpu_torch.parallel import multihost
from tests.test_torch_train_e2e import _port_cfg
from tests.tiny import random_batch, tiny_config
from tests.torch_dist_worker import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures",
                       "train64.json.gz")
DRAWINGS = 8
STEPS = 4          # 2 epochs of 2 global batches of 4


def _write_data(root):
    with gzip.open(FIXTURE, "rt") as f:
        infos = sorted(json.load(f), key=lambda i: len(i["lines"]))
    os.makedirs(root / "infos")
    names = []
    for info in infos[:DRAWINGS]:
        with open(root / "infos" / f"{info['name']}.json", "w") as f:
            json.dump(info, f)
        names.append(info["name"])
    with open(root / "split.txt", "w") as f:
        f.write("".join(f"{n}.json\n" for n in names))
    return names


def _cfg(root, log_root, batch, **trainer):
    cfg = _port_cfg(tiny_config())
    return dataclasses.replace(
        cfg, ROOT=str(root / "infos"), DATASETS_TRAIN=str(root / "split.txt"),
        DATASETS_VALID=str(root / "split.txt"),
        DATASETS_TEST=str(root / "split.txt"), BATCH_SIZE=batch, LR=3e-3,
        NUM_WORKERS=0,
        DATA=dataclasses.replace(cfg.DATA, MAX_INPUT_LENGTH=384,
                                 MAX_OUTPUT_LENGTH=64, AUG_RATIO=0.5),
        MODEL=dataclasses.replace(cfg.MODEL, DROPOUT=0.1),
        trainer=dataclasses.replace(cfg.trainer, **{
            "max_epochs": 2, "check_val_every_n_epoch": 2,
            "log_every_n_steps": 1, "kv_quantum": 32,
            "default_root_dir": str(log_root), **trainer}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    names = _write_data(tmp)
    yaml = {}
    for tag, batch, trainer in (
            ("dp2", 2, dict(devices=2)),
            ("tp2", 4, dict(devices=1, strategy="dp+tp",
                            tensor_parallel=2)),
            ("one", 4, dict(devices=1)),
            ("reload", 4, dict(devices=1))):
        yaml[tag] = str(tmp / f"{tag}.yaml")
        write_hparams_yaml(_cfg(tmp, tmp / f"logs_{tag}", batch, **trainer),
                           yaml[tag])

    def job(tag, out, **args):
        return {"fn": "fit", "out": str(tmp / f"{out}.npz"),
                "args": dict(cfg=yaml[tag], **args)}

    env = [{"PLANK_NUM_PROCESSES": "2", "PLANK_PROCESS_ID": str(r),
            "PLANK_COORDINATOR": f"file://{tmp}/rdv_env"} for r in range(2)]
    tp_init = f"file://{tmp}/rdv_tp"
    phases = [
        [job("dp2", f"dp2.r{r}", env=env[r], save=str(tmp / "dp2_ckpt.txt"))
         for r in range(2)],
        [job("tp2", f"tp2.r{r}", init=tp_init, world=2, rank=r, test=False,
             save=str(tmp / "tp2_ckpt.txt")) for r in range(2)],
        [job("one", "one", validate=False, test=False),
         job("reload", "reload_dp2", reload=str(tmp / "dp2_ckpt.txt"))],
        [job("reload", "reload_tp2", reload=str(tmp / "tp2_ckpt.txt"),
             test=False)],
    ]
    spawn(phases, tmp)

    def load(tag):
        with np.load(tmp / f"{tag}.npz") as z:
            return {k: z[k] for k in z.files}

    return {"load": load, "names": names, "tmp": tmp}


def _losses(log_dir):
    with open(os.path.join(str(log_dir), "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if "train/loss" in r], recs


def test_two_process_fit_equals_one_process(runs):
    """Each rank packs its half of every global batch of 4, augmentation
    included: the logged global losses equal the one-process run's of
    BATCH_SIZE 4, step for step, and so do the parameters."""
    dp = [runs["load"](f"dp2.r{r}") for r in range(2)]
    one = runs["load"]("one")
    assert [list(d["mesh"]) for d in dp] == [[2, 1], [2, 1]]
    assert [list(d["rows"]) for d in dp] == [[0, 2], [2, 4]]
    assert str(dp[0]["log_dir"]) == str(dp[1]["log_dir"])
    got, _ = _losses(dp[0]["log_dir"])
    want, _ = _losses(one["log_dir"])
    assert [r["step"] for r in got] == [r["step"] for r in want] == \
        list(range(1, STEPS + 1))
    np.testing.assert_allclose([r["train/loss"] for r in got],
                               [r["train/loss"] for r in want], rtol=2e-5)
    np.testing.assert_allclose([r["train/accuracy"] for r in got],
                               [r["train/accuracy"] for r in want],
                               atol=1e-6)
    for key in one:
        if key.startswith("param/") and not key.endswith("/bk"):
            np.testing.assert_allclose(dp[0][key], one[key], atol=2e-5,
                                       err_msg=key)
            np.testing.assert_array_equal(dp[0][key], dp[1][key])


def test_rank_zero_writes_the_logs(runs):
    """metrics.jsonl holds each step once and the validation once (rank 1
    opened no log); hparams.yaml, the checkpoint and the one TensorBoard
    stream are rank 0's."""
    dp = runs["load"]("dp2.r0")
    steps, recs = _losses(dp["log_dir"])
    assert len(steps) == STEPS
    assert sum("val/fmeasure" in r for r in recs) == 1
    assert sum("test/fmeasure" in r for r in recs) == 1
    log_dir = str(dp["log_dir"])
    names = sorted(os.listdir(log_dir))
    events = [n for n in names if n.startswith("events.out.tfevents.")]
    assert len(events) == 1
    assert [n for n in names if n not in events] == [
        "checkpoints", "hparams.yaml", "metrics.jsonl", "pred_jsons"]


def test_validation_and_test_reduce_globally(runs):
    """Validation and test of the 2-process run's final parameters: both
    ranks report the scores of the whole split, equal to one process
    decoding the same checkpoint; the kv bucket of each batch is the
    global batch's on both ranks, though rank 0's own rows would take a
    smaller one."""
    dp = [runs["load"](f"dp2.r{r}") for r in range(2)]
    one = runs["load"]("reload_dp2")
    for d in dp:
        np.testing.assert_allclose(d["val"], one["val"], rtol=1e-12)
        np.testing.assert_allclose(d["test"], one["test"], rtol=1e-12)
    got = [d["val_buckets"] for d in dp]   # (global, own) per batch
    np.testing.assert_array_equal(got[0][:, 0], got[1][:, 0])
    np.testing.assert_array_equal(got[0][:, 0], one["val_buckets"][:, 0])
    np.testing.assert_array_equal(one["val_buckets"][:, 0],
                                  one["val_buckets"][:, 1])
    assert (got[0][:, 1] < got[0][:, 0]).any()


def test_prediction_jsons_disjoint_and_complete(runs):
    """Each rank writes the JSONs of its own rows: no name twice, every
    drawing once, each equal to the one-process test's of the same
    checkpoint."""
    dp = [runs["load"](f"dp2.r{r}") for r in range(2)]
    one = runs["load"]("reload_dp2")
    written = [set(d["written"].tolist()) for d in dp]
    assert written[0] and written[1] and not written[0] & written[1]
    assert written[0] | written[1] == set(runs["names"])
    assert set(one["written"].tolist()) == set(runs["names"])
    for name in runs["names"]:
        paths = [os.path.join(str(d["log_dir"]), "pred_jsons",
                              f"{name}.json") for d in (dp[0], one)]
        a, b = (json.load(open(p)) for p in paths)
        assert a == b, name


def test_tensor_parallel_checkpoint_reloads_on_one_device(runs):
    """A tp=2 run saves the gathered parameters and Adam state; one
    process reloads them whole, at the same step, and validates to the
    same scores."""
    tp = [runs["load"](f"tp2.r{r}") for r in range(2)]
    one = runs["load"]("reload_tp2")
    assert list(tp[0]["mesh"]) == [1, 2]
    for key in tp[0]:
        if key.startswith("param/"):
            np.testing.assert_array_equal(tp[0][key], tp[1][key])
            np.testing.assert_array_equal(one[key], tp[0][key])
    np.testing.assert_allclose(one["val"], tp[0]["val"], rtol=1e-12)
    with open(runs["tmp"] / "tp2_ckpt.txt") as f:
        blob = torch.load(f.read(), weights_only=True)
    assert blob["step"] == STEPS
    wq = blob["params"]["encoder/self_attn/wq"]
    moments = blob["opt_state"]["state"]
    assert any(m["exp_avg"].shape == wq.shape for m in moments.values())


def test_initialize_from_env_without_a_group_is_a_no_op(monkeypatch):
    for key in ("PLANK_NUM_PROCESSES", "PLANK_DISTRIBUTED"):
        monkeypatch.delenv(key, raising=False)
    assert multihost.initialize_from_env(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert multihost.world_size() == 1 and multihost.is_main()
    assert multihost.owned_row_range(8) == (0, 8)
    assert multihost.host_allsum([1.5, 2]).tolist() == [1.5, 2.0]
    assert multihost.host_allmax(3) == 3


def test_data_parallel_artifact_equals_one_device(tmp_path):
    """export(data_parallel=2) on the CPU: the header carries the split,
    the loaded program decodes the request's rows in two chunks in turn,
    and every program equals the one-device artifact's."""
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.export import (
        export_serving, load_artifact, save_artifact,
    )
    from plankassembly_tpu_torch.models.model import init_params

    cfg = _port_cfg(tiny_config())
    params = init_params(torch.Generator().manual_seed(3),
                         ModelDims.from_config(cfg))
    batch = {k: v for k, v in random_batch(tiny_config(), batch_size=3,
                                           seed=4).items()
             if k.startswith("input")}
    outs = []
    for dp in (1, 2):
        blob, meta = export_serving(params, cfg, batch=4, bucket=31,
                                    compute_dtype=torch.float32,
                                    data_parallel=dp)
        path = str(tmp_path / f"dp{dp}.ptrv")
        save_artifact(path, blob, meta)
        prog = load_artifact(path, device="cpu")
        assert prog.meta["data_parallel"] == dp
        outs.append(prog(batch))
    for key in ("samples", "attach", "num_steps"):
        np.testing.assert_array_equal(outs[0][key], outs[1][key])
    assert outs[1]["samples"].shape[0] == 3
