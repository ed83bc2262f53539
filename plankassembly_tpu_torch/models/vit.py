"""The raster/ViT variant: a patch encoder in front of the same decoder and
pointer head; the port of `plankassembly_tpu/models/vit.py`.

The three views arrive as a (3, S, S) image instead of line tokens. Each
view is cut into (S/p)^2 patches; a patch token is the patch's pixels
projected to the model width (in float32), plus a learned 2-D position
embedding and the view embedding. The encoder stack, the loss and the
decode loops are the line model's: `run_encoder_stack` with no pad mask
(every patch token is real, so each row's kv length is T = 3 (S/p)^2),
`decode.decode_from_memory` and `beam.beam_decode_from_memory`.
"""
from __future__ import annotations

import dataclasses

import torch

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.models.model import (
    NEG_INF, _default_rng, _xavier, decode_stack, embed_output, init_params,
    run_encoder_stack, token_loss, train_dists,
)


@dataclasses.dataclass(frozen=True)
class VitDims:
    image_size: int = 256
    patch_size: int = 16

    @property
    def patches_per_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def tokens_per_view(self) -> int:
        return self.patches_per_side ** 2

    @property
    def num_tokens(self) -> int:
        return 3 * self.tokens_per_view


def init_vit_params(gen: torch.Generator, dims: ModelDims,
                    vit: VitDims) -> dict:
    """The line model's parameters (`init_params`) plus the patch
    projection `embed/patch` (p^2, D) and the patch position embedding
    `embed/pos_patch` ((S/p)^2, D), drawn from `gen`."""
    params = init_params(gen, dims)
    d = dims.num_model
    params["embed"]["patch"] = _xavier(gen, (vit.patch_size ** 2, d))
    params["embed"]["pos_patch"] = _xavier(gen, (vit.tokens_per_view, d))
    return params


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, V, S, S) -> (B, V * (S/p)^2, p^2)."""
    B, V, S, _ = images.shape
    n = S // patch
    x = images.reshape(B, V, n, patch, n, patch)
    x = x.permute(0, 1, 2, 4, 3, 5)
    return x.reshape(B, V * n * n, patch * patch)


def batch_images(batch: dict, vit: VitDims) -> torch.Tensor:
    """The raster input of a batch: its host-drawn `input_image`, or its
    packed segments drawn on their device (`data.raster.rasterize_device`)."""
    if "input_image" in batch:
        return batch["input_image"]
    from plankassembly_tpu_torch.data.raster import rasterize_device
    return rasterize_device(batch["input_lines"], batch["input_line_view"],
                            batch["input_line_inten"], vit.image_size)


def encode_raster(params, images, dims: ModelDims, vit: VitDims, *, rng=None,
                  deterministic=True, compute_dtype=torch.bfloat16,
                  flash=False, mesh=None):
    """ViT encoder: images (B, 3, S, S) -> memory (B, T, D), T = 3 (S/p)^2.
    The patch projection is a float32 product (TF32 off, PyTorch's
    default); under tensor parallelism (`mesh`) it stays replicated, as
    every leaf outside the attention and FFN blocks."""
    emb = params["embed"]
    tokens = patchify(images.float(), vit.patch_size)
    x = tokens @ emb["patch"]  # (B, T, D)
    T = vit.tokens_per_view
    pos = emb["pos_patch"].repeat(3, 1)  # (3T, D)
    view_ids = torch.arange(3, device=x.device).repeat_interleave(T)
    x = x + pos[None] + emb["view"][view_ids][None]
    no_pad = torch.zeros(x.shape[:2], dtype=torch.bool, device=x.device)
    return run_encoder_stack(params, x, no_pad, dims, rng=rng,
                             deterministic=deterministic,
                             compute_dtype=compute_dtype, flash=flash,
                             mesh=mesh)


def train_step_loss_raster(params, batch, dims: ModelDims, vit: VitDims, *,
                           rng=None, deterministic=False,
                           compute_dtype=torch.bfloat16, flash=False,
                           mesh=None):
    """Teacher-forced NLL and token accuracy of a raster batch, as
    `model.train_step_loss` with the ViT encoder: (loss, {"loss",
    "accuracy"}), the global batch's with a `mesh`."""
    dev = batch["output_value"].device
    if not deterministic:
        rng = _default_rng(rng, dev)
    memory = encode_raster(params, batch_images(batch, vit), dims, vit,
                           rng=rng, deterministic=deterministic,
                           compute_dtype=compute_dtype, flash=flash,
                           mesh=mesh)
    x = embed_output(params, batch["output_value"][:, :-1], dims)
    S = x.shape[1]
    causal = torch.triu(torch.full((S, S), NEG_INF, device=dev),
                        diagonal=1)[None, None]
    out_mask = batch["output_mask"][:, :S]
    tgt_pad = torch.where(out_mask, NEG_INF, 0.0)[:, None, None, :].float()
    B, T = memory.shape[:2]
    cross_bias = torch.zeros((1, 1, 1, T), device=dev)
    self_lengths = (~out_mask).sum(dim=-1).to(torch.int32)
    cross_lengths = torch.full((B,), T, dtype=torch.int32, device=dev)
    hiddens = decode_stack(params, x, memory, causal + tgt_pad, cross_bias,
                           dims, rng=rng, deterministic=deterministic,
                           compute_dtype=compute_dtype, flash=flash,
                           self_lengths=self_lengths,
                           cross_lengths=cross_lengths, mesh=mesh)
    return token_loss(train_dists(params, hiddens, dims),
                      batch["output_label"], dims, mesh)


def _memory(params, batch, dims, vit, compute_dtype):
    """Encoder memory of a raster batch (the encoder's attention through
    `flash_attention`) and its pad mask, all False."""
    memory = encode_raster(params, batch_images(batch, vit), dims, vit,
                           deterministic=True, compute_dtype=compute_dtype,
                           flash=True)
    return memory, torch.zeros(memory.shape[:2], dtype=torch.bool,
                               device=memory.device)


@torch.no_grad()
def greedy_decode_raster(params, batch, dims: ModelDims, vit: VitDims,
                         compute_dtype=torch.bfloat16, early_exit=True):
    """KV-cached greedy decode of a raster batch by
    `decode.decode_from_memory` with `cross_impl="auto"` (on CUDA "mxu"
    for an MHA model, as JAX's; the "fused" path cannot take a memory of
    T keys unless T is a multiple of its 128-key chunk)."""
    from plankassembly_tpu_torch.decode import decode_from_memory

    memory, no_pad = _memory(params, batch, dims, vit, compute_dtype)
    return decode_from_memory(params, memory, no_pad, dims,
                              compute_dtype=compute_dtype,
                              early_exit=early_exit)


@torch.no_grad()
def beam_decode_raster(params, batch, dims: ModelDims, vit: VitDims,
                       num_beams: int = 4, compute_dtype=torch.bfloat16,
                       alpha: float = 0.0):
    """Beam-search decode of a raster batch
    (`beam.beam_decode_from_memory` over the ViT memory)."""
    from plankassembly_tpu_torch.beam import beam_decode_from_memory

    memory, no_pad = _memory(params, batch, dims, vit, compute_dtype)
    return beam_decode_from_memory(params, memory, no_pad, dims,
                                   num_beams=num_beams,
                                   compute_dtype=compute_dtype, alpha=alpha)
