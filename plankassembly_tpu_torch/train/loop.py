"""Training, validation and test for the three line modalities
(`plankassembly_tpu/train/loop.py`):

- `Trainer`, the complete-lines modality (the reference's
  `trainer_complete.py`): LineDataset with train-time noise augmentation;
- `VisibleTrainer`, the visible-lines modality: LineDataset with
  augmentation off for training, the reference's slip that the published
  visible checkpoint was trained with;
- `SidefaceTrainer`, the sideface modality: SidefaceDataset; a test
  drawing with no detected side face scores 0, is left out of the
  criterion, and its prediction JSON holds no planks; its JSONs carry no
  `attach` key.

Adam, validation by greedy decode, prediction-JSON dumps bit-compatible
with the reference's, and checkpoints. `trainer.sample_cache` reads the
clean samples from a packed-sample cache (`data/cache.py`) under
`<default_root_dir>/.sample_cache`; `trainer.device_data` also holds the
cached training split on the device and assembles each batch there
(`data/device_loader.py`), as in JAX.

Parallelism, as JAX's: the mesh is `trainer.devices` data replicas,
clamped to the processes there are (over `trainer.tensor_parallel` when
`strategy` is "dp+tp"), each taking BATCH_SIZE rows of a global batch of
BATCH_SIZE * replicas; one process per device (`parallel/multihost.py`),
`cuda:<LOCAL_RANK>` unless the caller names a device. Logs, hparams.yaml
and checkpoints are written by rank 0; a checkpoint holds the gathered
parameters and Adam state, so it loads under any layout. Validation and
test gather the parameters, decode each data replica's rows at the global
batch's kv bucket, sum the criterion over the data group, and write each
row's prediction JSON from model rank 0 of its replica.

Differences from the JAX trainer:
- tensor parallelism splits whole heads and FFN units only, so
  `tensor_parallel` must divide the query and kv heads and NUM_FEEDFORWARD;
- `device_data` applies in a one-process world only, as in JAX; with more
  processes the trainer takes the plain loader and says so;
- with `trainer.fused_attention`, attention runs the fused kernels at
  every batch size on a CUDA device (the JAX trainer takes its kernel only
  on a TPU), and their plain versions on the CPU;
- validation and test decode as the JAX trainer does, by
  `trainer.decode_impl` ("auto", "xla", "mxu", "kernel", "fused",
  "persistent", or "beam<K>" for beam search), with int8 cross K/V where
  `trainer.kv_quant` asks for it; "auto" is the full-precision "mxu" path
  on a GPU unless `kv_quant` is set;
- checkpoints are `torch.save` files (params, Adam state, step) beside the
  same `.meta.json`, not orbax directories;
- the augmentation RNG is a `np.random.RandomState(seed_everything)`, not
  numpy's unseeded global one;
- `device_data` with the sideface modality trains: the JAX device loader
  calls the sideface dataset's `_pack` with a signature that dataset does
  not have, so an augmented row raises there.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from plankassembly_tpu_torch.config import Config, ModelDims, write_hparams_yaml
from plankassembly_tpu_torch.data.device_loader import DeviceDataLoader
from plankassembly_tpu_torch.data.line_data import LineDataset
from plankassembly_tpu_torch.data.loader import DataLoader, parse_splits_list
from plankassembly_tpu_torch.data.sideface_data import SidefaceDataset
from plankassembly_tpu_torch.beam import beam_decode
from plankassembly_tpu_torch.decode import (
    IMPLS, greedy_decode, parse_sequence, pick_kv_bucket,
)
from plankassembly_tpu_torch.device import resolve_device
from plankassembly_tpu_torch.metrics import (
    build_criterion, hungarian_match_host, metric_sums,
)
from plankassembly_tpu_torch.models.model import init_params
from plankassembly_tpu_torch.parallel import multihost
from plankassembly_tpu_torch.parallel.mesh import (
    check_tensor_parallel, gather_leaf, gather_params, make_mesh, shard_leaf,
    shard_params, spec_for_path,
)
from plankassembly_tpu_torch.train.state import (
    TrainState, init_state, make_device_train_step, make_optimizer,
    make_train_step, tree_leaves,
)
from plankassembly_tpu_torch.utils.profiling import StepTimer
from plankassembly_tpu_torch.utils.tb_writer import TensorBoardWriter


def beam_width(decode_impl: str) -> int:
    """K of a "beam<K>" decode_impl, 0 for a greedy one; raises on a name
    that is neither."""
    if decode_impl.startswith("beam") and decode_impl[4:].isdigit():
        return int(decode_impl[4:])
    if decode_impl not in IMPLS:
        raise ValueError(f"unknown trainer.decode_impl {decode_impl!r}; one "
                         f"of {IMPLS} or beam<K>")
    return 0


class MetricsLogger:
    """JSONL + stdout + TensorBoard logger, as JAX's: `metrics.jsonl` and an
    `events.out.tfevents.*` stream (`utils/tb_writer.py`; every numeric
    value but the epoch, the reference's Lightning TensorBoard surface,
    `trainer_complete.py:69-70,87-89`) in the run directory; rank 0 only
    in a process group."""

    def __init__(self, log_dir: str):
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = self._tb = None
        if multihost.is_main():
            os.makedirs(log_dir, exist_ok=True)
            self._f = open(self.path, "a")
            self._tb = TensorBoardWriter(log_dir)

    def log(self, step: int, payload: dict):
        if self._f is None:
            return
        rec = {"step": step, "time": time.time(), **payload}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        for key, value in payload.items():
            if isinstance(value, (int, float)) and key != "epoch":
                self._tb.add_scalar(key, float(value), step,
                                    wall_time=rec["time"])
        self._tb.flush()
        pretty = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in payload.items())
        print(f"[step {step}] {pretty}", flush=True)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._tb.close()
            self._f = self._tb = None


def _to_device(batch: dict, device) -> dict:
    """The batch's arrays as tensors on `device` (pinned and copied
    asynchronously to a GPU); other fields dropped."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and not k.startswith("_"):
            t = torch.from_numpy(v)
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
    return out


class Trainer:
    """Complete-lines modality trainer, on one device or one rank of a
    mesh."""

    dataset_cls = LineDataset
    train_augmentation = True

    def __init__(self, cfg: Config, log_dir: str | None = None,
                 compute_dtype=torch.bfloat16, device=None):
        tc = cfg.trainer
        self.num_beams = beam_width(tc.decode_impl)
        self.cfg = cfg
        self.dims = ModelDims.from_config(cfg)
        tp = max(1, tc.tensor_parallel) if tc.strategy == "dp+tp" else 1
        check_tensor_parallel(self.dims, tp)
        num_data = max(1, min(tc.devices, multihost.world_size() // tp))
        self.mesh = make_mesh(num_data, tp)
        self.global_batch = cfg.BATCH_SIZE * num_data
        self.compute_dtype = compute_dtype
        self.device = resolve_device(
            device if device is not None else multihost.default_device())
        self.detect_anomaly = tc.detect_anomaly
        self.log_dir = multihost.broadcast_object(log_dir or os.path.join(
            tc.default_root_dir, f"version_{int(time.time())}"),
            self.mesh.host_group)
        os.makedirs(self.log_dir, exist_ok=True)
        self.logger = MetricsLogger(self.log_dir)
        if multihost.is_main():
            write_hparams_yaml(cfg, os.path.join(self.log_dir,
                                                 "hparams.yaml"))
        self.optimizer = make_optimizer(cfg.LR)
        self.train_step_fn = make_train_step(
            self.dims, compute_dtype=compute_dtype,
            flash=tc.fused_attention, mesh=self._step_mesh)
        self.device_step_fn = make_device_train_step(
            self.dims, compute_dtype=compute_dtype,
            flash=tc.fused_attention, mesh=self._step_mesh)
        self._rng = torch.Generator(device=self.device).manual_seed(
            cfg.seed_everything)
        self._aug_rng = np.random.RandomState(cfg.seed_everything)
        self._eval_orders: dict = {}

    @property
    def _step_mesh(self):
        """The mesh the model functions take: None in a single process."""
        return self.mesh if self.mesh.data_group is not None else None

    @property
    def rows(self) -> tuple[int, int]:
        """This rank's rows of each global batch."""
        return multihost.owned_row_range(self.global_batch, self.mesh)

    def close(self):
        """Close the metrics log (the trainer stays usable without it for
        checkpoints)."""
        self.logger.close()

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def _dataset(self, split_files: str, augmentation: bool):
        tc = self.cfg.trainer
        cache_dir = (os.path.join(tc.default_root_dir, ".sample_cache")
                     if tc.sample_cache or tc.device_data else None)
        return self.dataset_cls(self.cfg.ROOT, parse_splits_list(split_files),
                                self.cfg, augmentation=augmentation,
                                rng=self._aug_rng if augmentation else None,
                                cache_dir=cache_dir)

    def train_dataloader(self):
        """`DeviceDataLoader` over the cached split with
        `trainer.device_data` in a single process, else `DataLoader` over
        this rank's rows."""
        ds = self._dataset(self.cfg.DATASETS_TRAIN, self.train_augmentation)
        if self.cfg.trainer.device_data and ds._cache is not None:
            if multihost.world_size() == 1:
                return DeviceDataLoader(ds, ds._cache, self.cfg.BATCH_SIZE,
                                        self.device,
                                        seed=self.cfg.seed_everything)
            if multihost.is_main():
                print("trainer.device_data applies in a single process; "
                      f"{multihost.world_size()} processes take the host "
                      "loader", flush=True)
        return DataLoader(ds, batch_size=self.global_batch, shuffle=True,
                          drop_last=True, seed=self.cfg.seed_everything,
                          num_workers=self.cfg.NUM_WORKERS, rows=self.rows)

    def _eval_order(self, dataset):
        """Eval batches sorted by (program length, line count), so rows
        that exit early together share a batch and a small kv bucket;
        cached per dataset."""
        key = (dataset.root, tuple(dataset.info_files))
        if key not in self._eval_orders:
            keys = []
            for name in dataset.info_files:
                try:
                    with open(os.path.join(dataset.root, name)) as f:
                        info = json.load(f)
                    keys.append((len(info.get("coords", [])),
                                 len(info.get("lines", []))))
                except (OSError, ValueError):
                    keys.append((1 << 30, 1 << 30))
            self._eval_orders[key] = np.lexsort(
                ([k[1] for k in keys], [k[0] for k in keys]))
        return self._eval_orders[key]

    def _eval_dataloader(self, split_files: str) -> DataLoader:
        ds = self._dataset(split_files, False)
        return DataLoader(ds, batch_size=self.global_batch,
                          order=self._eval_order(ds),
                          num_workers=self.cfg.NUM_WORKERS, pad_to_batch=True,
                          rows=self.rows)

    def val_dataloader(self) -> DataLoader:
        return self._eval_dataloader(self.cfg.DATASETS_VALID)

    def test_dataloader(self) -> DataLoader:
        return self._eval_dataloader(self.cfg.DATASETS_TEST)

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------
    def init_state(self, seed: int | None = None) -> TrainState:
        gen = torch.Generator().manual_seed(
            seed if seed is not None else self.cfg.seed_everything)
        return self._state(init_params(gen, self.dims))

    def _state(self, params: dict, opt_state: dict | None = None,
               step: int = 0) -> TrainState:
        """A TrainState of this rank's shards of the whole tree `params`
        (and of the whole Adam state `opt_state`, when given)."""
        state = init_state(shard_params(params, self.mesh), self.optimizer,
                           device=self.device)
        if opt_state is not None:
            state.optimizer.load_state_dict(self._map_opt_state(
                opt_state, params, shard_leaf))
        state.step = step
        return state

    def _map_opt_state(self, opt_state: dict, params: dict, fn) -> dict:
        """The Adam state with fn(tensor, split axis, mesh) applied to each
        parameter's moment tensors (Adam's index i is leaf i of
        `tree_leaves(params)`)."""
        tp = self.mesh.tensor_parallel
        axes = [spec_for_path("/".join(p), tp) for p, _ in tree_leaves(params)]
        state = {i: {k: (fn(v, axes[int(i)], self.mesh)
                         if torch.is_tensor(v) and v.dim() else v)
                     for k, v in s.items()}
                 for i, s in opt_state["state"].items()}
        return {**opt_state, "state": state}

    def fit(self, state: TrainState | None = None,
            max_epochs: int | None = None) -> TrainState:
        cfg, tc = self.cfg, self.cfg.trainer
        state = state if state is not None else self.init_state()
        max_epochs = max_epochs or tc.max_epochs
        best_f1 = -1.0
        loader = self.train_dataloader()
        timer = StepTimer()
        try:
            for epoch in range(max_epochs):
                for batch in loader:
                    if "idx" in batch:  # device-resident data
                        mets = self.device_step_fn(
                            state, loader.fields, batch["idx"], batch["aug"],
                            batch["pos"], self._rng)
                    else:
                        mets = self.train_step_fn(
                            state, _to_device(batch, self.device), self._rng)
                    timer.tick(mets["loss"])
                    if state.step % tc.log_every_n_steps == 0:
                        self._log_step(state.step, epoch, mets, timer)
                if (epoch + 1) % tc.check_val_every_n_epoch == 0:
                    prec, rec, f1 = self.validate(state)
                    self.logger.log(state.step, {
                        "epoch": epoch, "val/precision": prec,
                        "val/recall": rec, "val/fmeasure": f1})
                    if f1 > best_f1:
                        best_f1 = f1
                        self.save_checkpoint(state, "best", epoch=epoch,
                                             metrics={"val/precision": prec,
                                                      "val/recall": rec,
                                                      "val/fmeasure": f1})
                    if tc.save_last:
                        self.save_checkpoint(state, "last", epoch=epoch)
            if tc.save_last:
                self.save_checkpoint(state, "last", epoch=max_epochs - 1)
        finally:
            loader.close()
        return state

    def _log_step(self, step, epoch, mets, timer):
        loss = float(mets["loss"])
        if self.detect_anomaly and not np.isfinite(loss):
            raise FloatingPointError(
                f"non-finite train loss {loss} at step {step} (epoch "
                f"{epoch})")
        payload = {"epoch": epoch, "train/loss": loss,
                   "train/accuracy": float(mets["accuracy"])}
        if timer.steps_per_sec:
            payload["train/steps_per_sec"] = round(timer.steps_per_sec, 3)
        self.logger.log(step, payload)

    # ------------------------------------------------------------------
    # eval
    # ------------------------------------------------------------------
    def _eval_state(self, state: TrainState) -> TrainState:
        """`state` with the whole parameter tree, for decoding (gathered
        from the shards under tensor parallelism: every rank of the model
        group calls this)."""
        if not self.mesh.tensor_parallel:
            return state
        return dataclasses.replace(
            state, params=gather_params(state.params, self.mesh))

    def _criterion_total(self, criterion):
        """The criterion summed over the data group (every data replica's
        rows once)."""
        totals = multihost.host_allsum(
            [criterion.precision, criterion.recall, criterion.fmeasure,
             criterion.total], self.mesh.host_data_group)
        criterion.precision, criterion.recall, criterion.fmeasure = (
            float(totals[0]), float(totals[1]), float(totals[2]))
        criterion.total = int(totals[3])
        return criterion.compute()

    def _decode_batch(self, state: TrainState, batch: dict):
        """(the batch's tensors, the decode of its rows) at the global
        batch's kv bucket (the largest of the data replicas')."""
        arrays = _to_device(batch, self.device)
        inputs = {k: v for k, v in arrays.items() if k.startswith("input")}
        tc = self.cfg.trainer
        bucket = multihost.host_allmax(
            pick_kv_bucket(batch["input_mask"], quantum=tc.kv_quantum),
            self.mesh.host_data_group)
        if self.num_beams:
            out = beam_decode(state.params, inputs, self.dims,
                              num_beams=self.num_beams,
                              compute_dtype=self.compute_dtype,
                              kv_bucket=bucket)
            return arrays, out
        # kv_quant False is the config's default, not a request for full
        # precision: None keeps "persistent" from warning on every batch
        out = greedy_decode(state.params, inputs, self.dims,
                            compute_dtype=self.compute_dtype,
                            kv_bucket=bucket, kv_quant=tc.kv_quant or None,
                            cross_impl=tc.decode_impl)
        return arrays, out

    def validate(self, state: TrainState) -> tuple[float, float, float]:
        criterion = build_criterion()
        state = self._eval_state(state)
        loader = self.val_dataloader()
        try:
            for batch in loader:
                arrays, out = self._decode_batch(state, batch)
                p, r, f, n = metric_sums(
                    out["samples"], arrays["output_value"],
                    arrays["sample_valid"], end=self.cfg.TOKEN.END,
                    dof=self.dims.num_output_dof,
                    threshold=self.cfg.THRESHOLD)
                criterion.update(float(p), float(r), float(f),
                                 count=int(float(n)))
        finally:
            loader.close()
        return self._criterion_total(criterion)

    def test(self, state: TrainState) -> tuple[float, float, float]:
        """Decode the test split, write one prediction JSON per drawing
        (`pred_jsons/<name>.json`, the reference's format; each by model
        rank 0 of the data replica that decoded it) and return the macro
        P/R/F1 of the reference matcher over the whole split."""
        pred_dir = os.path.join(self.log_dir, "pred_jsons")
        os.makedirs(pred_dir, exist_ok=True)
        writes = self.mesh.model_rank == 0
        criterion = build_criterion()
        state = self._eval_state(state)
        loader = self.test_dataloader()
        try:
            for batch in loader:
                arrays, out = self._decode_batch(state, batch)
                samples = out["samples"].cpu().numpy()
                attach = out["attach"].cpu().numpy()
                gts = batch["output_value"]
                # a raster batch has no token mask: one zero per row for
                # the prediction JSONs' contract
                in_masks = batch.get("input_mask",
                                     np.zeros((len(samples), 1), bool))
                for i, name in enumerate(batch["name"]):
                    if not batch["_local_valid"][i]:
                        continue
                    scores = self._write_prediction(
                        pred_dir if writes else None, name, samples[i],
                        attach[i], gts[i], in_masks[i])
                    if scores is not None:
                        criterion.update(*scores)
        finally:
            loader.close()
        prec, rec, f1 = self._criterion_total(criterion)
        self.logger.log(state.step, {"test/precision": prec,
                                     "test/recall": rec,
                                     "test/fmeasure": f1})
        return prec, rec, f1

    def _write_prediction(self, pred_dir, name, sample, attach, gt, in_mask):
        """Write `pred_jsons/<name>.json` (not when `pred_dir` is None);
        returns (P, R, F1) for the criterion, or None to leave the drawing
        out of it."""
        valid_pred, gt_parsed = self._parse(sample, gt)
        prec, rec, f1 = hungarian_match_host(
            valid_pred[1:], gt_parsed[1:], self.cfg.THRESHOLD)
        _dump(pred_dir, name, {
            "prediction": valid_pred.tolist(),
            "attach": attach[: valid_pred.size].reshape(-1, 6).tolist(),
            "groundtruth": gt_parsed.tolist(),
            "precision": prec,
            "recall": rec,
            "fmeasure": f1,
        })
        return prec, rec, f1

    def _parse(self, sample, gt):
        """(predicted planks without the zero-extent ones, bbox row kept;
        ground-truth planks)."""
        pred = parse_sequence(sample, self.dims)
        if len(pred) > 0:
            body = pred[1:]
            keep = np.all(np.abs(body[:, 3:] - body[:, :3]) != 0, axis=1)
            pred = np.concatenate([pred[:1], body[keep]])
        return pred, parse_sequence(gt, self.dims)

    # ------------------------------------------------------------------
    # checkpoints: <log_dir>/checkpoints/<tag>.pt and <tag>.meta.json
    # ------------------------------------------------------------------
    def save_checkpoint(self, state: TrainState, tag: str, epoch: int = -1,
                        metrics: dict | None = None) -> str:
        """Write the whole parameters and Adam state (gathered from every
        rank's shards: every rank calls this) from rank 0."""
        ckpt_dir = os.path.join(self.log_dir, "checkpoints")
        path = os.path.join(ckpt_dir, f"{tag}.pt")
        whole = gather_params(state.params, self.mesh)
        opt_state = self._map_opt_state(
            state.optimizer.state_dict(), whole,
            lambda t, axis, mesh: gather_leaf(t, axis, mesh).cpu())
        if multihost.is_main():
            self._write_checkpoint(ckpt_dir, tag, whole, opt_state,
                                   state.step, epoch, metrics)
        multihost.barrier(self.mesh.host_group)  # on disk for every rank
        return path

    @staticmethod
    def _write_checkpoint(ckpt_dir, tag, whole, opt_state, step, epoch,
                          metrics):
        path = os.path.join(ckpt_dir, f"{tag}.pt")
        os.makedirs(ckpt_dir, exist_ok=True)
        params = {"/".join(p): t.cpu() for p, t in tree_leaves(whole)}
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"params": params, "opt_state": opt_state,
                    "step": step}, tmp)
        os.replace(tmp, path)  # a reader never sees half a file
        with open(os.path.join(ckpt_dir, f"{tag}.meta.json"), "w") as f:
            json.dump({"epoch": epoch, "step": step,
                       "metrics": metrics or {}}, f)

    def load_checkpoint(self, path: str) -> TrainState:
        """A training checkpoint of the port (`.pt`, or its path without
        the suffix) with its Adam state and step, or a released `.npz`
        (params only: a fresh Adam state at step 0)."""
        from plankassembly_tpu_torch.checkpoint import load_training_params
        params, opt_state, step = load_training_params(path)
        return self._state(params, opt_state, step)


def _dump(pred_dir, name, payload):
    if pred_dir is None:  # another rank of the model group writes it
        return
    with open(os.path.join(pred_dir, f"{name}.json"), "w") as f:
        json.dump(payload, f, indent=4, separators=(", ", ": "))


class VisibleTrainer(Trainer):
    """Visible-lines modality: the training split is never augmented (the
    reference's slip, kept: the published visible checkpoint was trained
    that way)."""

    train_augmentation = False


class SidefaceTrainer(Trainer):
    """Sideface modality (the reference's `trainer_sideface.py`)."""

    dataset_cls = SidefaceDataset
    train_augmentation = True

    def _write_prediction(self, pred_dir, name, sample, attach, gt, in_mask):
        valid_pred, gt_parsed = self._parse(sample, gt)
        if in_mask[1:].all():
            # no detected side face: zero scores, left out of the criterion
            _dump(pred_dir, name, {
                "prediction": [], "groundtruth": gt_parsed.tolist(),
                "precision": 0.0, "recall": 0.0, "fmeasure": 0.0})
            return None
        prec, rec, f1 = hungarian_match_host(
            valid_pred[1:], gt_parsed[1:], self.cfg.THRESHOLD)
        _dump(pred_dir, name, {
            "prediction": valid_pred.tolist(),
            "groundtruth": gt_parsed.tolist(),
            "precision": prec, "recall": rec, "fmeasure": f1})
        return prec, rec, f1
