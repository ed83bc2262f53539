"""Trainer of the raster/ViT modality
(`plankassembly_tpu/train/raster_loop.py`): the line trainer's fit,
validation, test, checkpoints and prediction JSONs with the raster
dataset, the ViT parameters and loss, and the raster decode.

`trainer.fused_attention` on a CUDA device runs the training attention
kernel (`ops/flash_train.py`) in the loss, the port's counterpart of the
JAX trainer's flash rule on a TPU; elsewhere the loss takes the plain
attention. Validation and test decode through `greedy_decode_raster`
(whose encoder runs `ops/attention.py`'s kernel on a CUDA device), or
`beam_decode_raster` for `trainer.decode_impl: beam<K>`; with no pad in
the memory they take no kv bucket. Under a mesh the ViT's leaves take the
line model's path rule (`parallel.mesh.spec_for_path`): the patch
projection and its position embedding stay replicated.
"""
from __future__ import annotations

from functools import partial

import torch

from plankassembly_tpu_torch.config import Config
from plankassembly_tpu_torch.data.raster import RASTER_KEYS, RasterDataset
from plankassembly_tpu_torch.models.vit import (
    VitDims, beam_decode_raster, greedy_decode_raster, init_vit_params,
    train_step_loss_raster,
)
from plankassembly_tpu_torch.train.loop import Trainer, _to_device
from plankassembly_tpu_torch.train.state import (
    TrainState, make_device_train_step, make_train_step,
)


class RasterTrainer(Trainer):
    """Raster images in (drawn on the device from packed segments), the
    ViT encoder, the line model's decoder."""

    train_augmentation = True

    def __init__(self, cfg: Config, log_dir: str | None = None,
                 compute_dtype=torch.bfloat16, device=None,
                 image_size: int | None = None,
                 patch_size: int | None = None):
        super().__init__(cfg, log_dir=log_dir, compute_dtype=compute_dtype,
                         device=device)
        self.vit = VitDims(image_size=image_size or cfg.DATA.IMAGE_SIZE,
                           patch_size=patch_size or cfg.DATA.PATCH_SIZE)
        self.dataset_cls = partial(RasterDataset,
                                   image_size=self.vit.image_size)
        step_kwargs = dict(
            compute_dtype=compute_dtype,
            flash=cfg.trainer.fused_attention and self.device.type == "cuda",
            loss_impl=partial(train_step_loss_raster, vit=self.vit),
            mesh=self._step_mesh)
        self.train_step_fn = make_train_step(self.dims, **step_kwargs)
        self.device_step_fn = make_device_train_step(self.dims, **step_kwargs)

    def init_state(self, seed: int | None = None) -> TrainState:
        gen = torch.Generator().manual_seed(
            seed if seed is not None else self.cfg.seed_everything)
        return self._state(init_vit_params(gen, self.dims, self.vit))

    def _decode_batch(self, state: TrainState, batch: dict):
        arrays = _to_device(batch, self.device)
        raster_in = {k: v for k, v in arrays.items() if k in RASTER_KEYS}
        if self.num_beams:
            out = beam_decode_raster(state.params, raster_in, self.dims,
                                     self.vit, num_beams=self.num_beams,
                                     compute_dtype=self.compute_dtype)
        else:
            out = greedy_decode_raster(state.params, raster_in, self.dims,
                                       self.vit,
                                       compute_dtype=self.compute_dtype)
        return arrays, out
