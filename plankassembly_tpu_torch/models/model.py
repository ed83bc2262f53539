"""The encoder-decoder, eager PyTorch: its building blocks, parameter
initialisation and the teacher-forced training loss.

Ports `plankassembly_tpu/models/model.py` with the same parameter layout
(nested dict, layers stacked on the leading axis, ``x @ W`` projections)
and the same dtype policy: matmuls in `compute_dtype`, scores, softmax and
layer norms in float32, the residual stream in the parameters' dtype.

The projections and FFNs are large plain products that the JAX package
leaves to XLA; here they are `torch.matmul`. With `flash`, attention over
suffix-padded keys goes through the kernels, which index the kv head of a
grouped-query model directly instead of repeating K/V: `ops.attention.
flash_attention` when `deterministic`, the differentiable
`ops.flash_train.fused_attention_train` (hashed in-kernel dropout) when
training. The JAX model takes those kernels only on a TPU and at
B*H >= 128 (`_flash_enabled`); here `flash` means the kernels at every
B*H on a CUDA device, and their plain versions on the CPU.

Randomness: JAX threads a PRNG key; here every random draw (dropout masks
and the seed of each fused-attention call) comes from one explicit
`torch.Generator` passed as `rng`, on the activations' device. The two
frameworks' bits differ; the tests compare with dropout 0, and the fused
kernel's masks against JAX's given the same seed.

Parallelism (`parallel/mesh.py`): with a `mesh`, a rank holds its data
replica's rows of the global batch and, under tensor parallelism, its
model rank's whole heads and FFN units (the projections' shapes say how
many). Every rank's generator is seeded alike and draws in the same order
at the global shapes, then keeps its own slice, so the masks are the
one-process run's masks: a plain mask is drawn at the global batch (and
head or FFN width) and sliced; the fused kernel's seed gets the rank's row
and head offsets folded in (`shard_seed`). The loss divides by the global
token count, so summing the ranks' gradients gives the global batch's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.ops.attention import flash_attention
from plankassembly_tpu_torch.ops.flash_train import (
    fused_attention_train, shard_seed,
)
from plankassembly_tpu_torch.parallel.mesh import (
    all_reduce_sum, copy_to_model, gather_seq, reduce_from_model,
)

NEG_INF = -1e9  # finite -inf stand-in: keeps softmax NaN-free on masked rows


def layer_norm(p, x, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return out.to(x.dtype)


def _xavier(gen, shape):
    """Xavier-uniform over the last two axes, as the JAX model (and the
    reference's blanket re-init of every parameter with dim > 1)."""
    fan_in, fan_out = shape[-2], shape[-1]
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


def _init_attn(gen, dims: ModelDims, layers: int):
    d = dims.num_model
    dkv = dims.kv_heads * dims.head_dim
    return {
        "wq": _xavier(gen, (layers, d, d)),
        "wk": _xavier(gen, (layers, d, dkv)),
        "wv": _xavier(gen, (layers, d, dkv)),
        "wo": _xavier(gen, (layers, d, d)),
        "bq": torch.zeros((layers, d)),
        "bk": torch.zeros((layers, dkv)),
        "bv": torch.zeros((layers, dkv)),
        "bo": torch.zeros((layers, d)),
    }


def _init_ffn(gen, dims: ModelDims, layers: int):
    d, f = dims.num_model, dims.num_feedforward
    return {"w1": _xavier(gen, (layers, d, f)), "b1": torch.zeros((layers, f)),
            "w2": _xavier(gen, (layers, f, d)), "b2": torch.zeros((layers, d))}


def _init_norm(layers, d):
    shape = (d,) if layers is None else (layers, d)
    return {"scale": torch.ones(shape), "bias": torch.zeros(shape)}


def init_params(gen: torch.Generator, dims: ModelDims) -> dict:
    """The parameter tree of `plankassembly_tpu/models/model.py::
    init_params` (same shapes and bounds), as float32 CPU tensors drawn
    from `gen`."""
    d = dims.num_model
    embed = {
        "value": _xavier(gen, (dims.vocab_size, d)),
        "pos_in": _xavier(gen, (dims.max_num_input, d)),
        "coord_in": _xavier(gen, (dims.num_input_dof, d)),
        "view": _xavier(gen, (dims.num_view, d)),
        "type": _xavier(gen, (dims.num_type, d)),
        "coord_out": _xavier(gen, (dims.num_output_dof, d)),
        "pos_out": _xavier(gen, (dims.max_num_output, d)),
    }
    le, ld = dims.num_encoder_layers, dims.num_decoder_layers
    encoder = {
        "self_attn": _init_attn(gen, dims, le),
        "ffn": _init_ffn(gen, dims, le),
        "norm1": _init_norm(le, d),
        "norm2": _init_norm(le, d),
        "final_norm": _init_norm(None, d),
    }
    decoder = {
        "self_attn": _init_attn(gen, dims, ld),
        "cross_attn": _init_attn(gen, dims, ld),
        "ffn": _init_ffn(gen, dims, ld),
        "norm1": _init_norm(ld, d),
        "norm2": _init_norm(ld, d),
        "norm3": _init_norm(ld, d),
        "final_norm": _init_norm(None, d),
    }
    heads = {
        "vocab": {"w": _xavier(gen, (d, dims.vocab_size)),
                  "b": torch.zeros((dims.vocab_size,))},
        "pointer": {"w": _xavier(gen, (d, d)), "b": torch.zeros((d,))},
        "switch": {"w": _xavier(gen, (d, 1)), "b": torch.zeros((1,))},
    }
    return {"embed": embed, "encoder": encoder, "decoder": decoder,
            "heads": heads}


def _project(x, w, b, cd):
    return x.to(cd) @ w.to(cd) + b.to(cd)


def _dropout(rng, x, rate, deterministic, shards=()):
    """Inverted dropout with a mask drawn from `rng`. `shards` lists the
    (axis, parts, index) of each axis along which x is one part of a
    larger tensor: the mask is drawn at that tensor's shape and sliced, so
    it is the slice of the mask the whole tensor would get."""
    if deterministic or rate == 0.0:
        return x
    shape = list(x.shape)
    for axis, parts, _ in shards:
        shape[axis] *= parts
    keep = torch.rand(shape, generator=rng, device=x.device) < 1.0 - rate
    for axis, _, index in shards:
        n = x.shape[axis]
        keep = keep.narrow(axis, index * n, n)
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


def _rows(mesh):
    """The batch shard of `mesh`'s rank, for `_dropout`."""
    return () if mesh is None else (mesh.row_shard,)


def _tp(mesh) -> bool:
    return mesh is not None and mesh.tensor_parallel


def _model_sum(x, mesh, cd):
    """The model group's sum of a row-parallel product (float32 on the
    wire), in the compute dtype."""
    if not _tp(mesh):
        return x
    return reduce_from_model(x.float(), mesh).to(cd)


def _draw_seed(rng, device):
    """One int32 seed in [0, 2^31 - 1) per fused-attention call, drawn on
    the device (no host sync), as the JAX model's `randint`."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=rng, device=device,
                         dtype=torch.int32)


def _default_rng(rng, device):
    return rng if rng is not None else \
        torch.Generator(device=device).manual_seed(0)


def attention(p, q_in, kv_in, bias, dims: ModelDims, *, rng=None,
              deterministic=True, compute_dtype=torch.bfloat16,
              kv_lengths=None, flash=False, causal=False, mesh=None,
              seq_mesh=None):
    """Multi-head (or grouped-query) attention. q_in (B,Lq,D), kv_in
    (B,Lk,D); bias broadcastable to (B,H,Lq,Lk) with 0 / NEG_INF entries.

    With `flash` and `kv_lengths` (B,) (pad keys form a suffix), the scores
    never materialise: the kernels take the kv-head-wide K/V and the
    lengths (`causal` must mirror what `bias` encodes). Otherwise the plain
    einsum path with the additive bias runs, repeating K/V over each group
    as the JAX model does. Training (`deterministic=False`) drops attention
    weights at `dims.dropout`.

    The head counts come from the projections, so a tensor-parallel rank
    (`mesh`) runs its own heads and sums the output projection over the
    model group before `bo` is added once. With `seq_mesh`, q_in and kv_in
    are this rank's slice of the length axis and K/V are gathered over the
    seq group."""
    B, Lq, _ = q_in.shape
    Dh, cd = dims.head_dim, compute_dtype
    H, kvH = p["wq"].shape[-1] // Dh, p["wk"].shape[-1] // Dh
    G = H // kvH
    if _tp(mesh):
        same = kv_in is q_in
        q_in = copy_to_model(q_in, mesh)
        kv_in = q_in if same else copy_to_model(kv_in, mesh)
    q = _project(q_in, p["wq"], p["bq"], cd).reshape(B, Lq, H, Dh)
    k = _project(kv_in, p["wk"], p["bk"], cd).reshape(B, -1, kvH, Dh)
    v = _project(kv_in, p["wv"], p["bv"], cd).reshape(B, -1, kvH, Dh)
    if seq_mesh is not None:
        k, v = (gather_seq(x, seq_mesh, reduce=True) for x in (k, v))
    shards = _rows(mesh)
    if _tp(mesh):
        shards += ((1, mesh.num_model, mesh.model_rank),)
    if flash and kv_lengths is not None:
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if deterministic:
            out = flash_attention(qh, kh, vh, kv_lengths, causal=causal)
        else:
            seed = _draw_seed(rng, q.device)
            if mesh is not None:
                seed = shard_seed(seed, mesh.data_rank * B,
                                  mesh.model_rank * H if _tp(mesh) else 0)
            out = fused_attention_train(qh, kh, vh, kv_lengths, seed,
                                        dims.dropout, causal)
        out = out.transpose(1, 2)
    else:
        if G > 1:
            k = k.repeat_interleave(G, dim=2)
            v = v.repeat_interleave(G, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(Dh)
        if bias is not None:
            scores = scores + bias
        weights = torch.softmax(scores, dim=-1)
        if not deterministic and dims.dropout > 0:
            weights = _dropout(rng, weights, dims.dropout, deterministic,
                               shards)
        out = torch.einsum("bhqk,bkhd->bqhd", weights.to(cd).float(),
                           v.float()).to(cd)
    out = out.reshape(B, Lq, H * Dh).to(cd)
    out = _model_sum(out @ p["wo"].to(cd), mesh, cd) + p["bo"].to(cd)
    return out.to(q_in.dtype)


def ffn(p, x, dims: ModelDims, *, rng=None, deterministic=True,
        compute_dtype=torch.bfloat16, mesh=None):
    """relu(x W1 + b1) W2 + b2, its hidden dropped at `dims.dropout`. A
    tensor-parallel rank holds its share of the hidden units and sums the
    second product over the model group before `b2` is added once."""
    cd = compute_dtype
    shards = _rows(mesh)
    if _tp(mesh):
        x_in = copy_to_model(x, mesh)
        shards += ((-1, mesh.num_model, mesh.model_rank),)
    else:
        x_in = x
    h = torch.relu(_project(x_in, p["w1"], p["b1"], cd))
    h = _dropout(rng, h, dims.dropout, deterministic, shards)
    out = _model_sum(h @ p["w2"].to(cd), mesh, cd) + p["b2"].to(cd)
    return out.to(x.dtype)


def _take_layer(stacked, i):
    return {k: (_take_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def _layers(tree, n):
    body = {k: v for k, v in tree.items() if k != "final_norm"}
    return [_take_layer(body, i) for i in range(n)]


def _embed(table, ids):
    """Rows of `table` at `ids`. `F.embedding` rather than indexing: the
    same values, but the gradient of an indexed read of 77k ids into a
    few hundred rows took 24 ms per table on an H100 (PyTorch's
    `indexing_backward_kernel`, 37% of a flagship training step in
    `tools/profile_torch_train.py`)."""
    return torch.nn.functional.embedding(ids.long(), table)


def encode(params, inputs: dict, dims: ModelDims, *, rng=None,
           deterministic=True, compute_dtype=torch.bfloat16, flash=False,
           mesh=None, seq_mesh=None):
    """Embed the input streams and run the pre-norm encoder stack.

    inputs: input_value/pos/coord/view[/type] (B, Li) integer tensors and
    input_mask (B, Li) bool (True = pad). Returns memory (B, Li, D) in the
    parameters' dtype."""
    emb = params["embed"]
    x = (_embed(emb["value"], inputs["input_value"])
         + _embed(emb["pos_in"], inputs["input_pos"])
         + _embed(emb["coord_in"], inputs["input_coord"])
         + _embed(emb["view"], inputs["input_view"]))
    if "input_type" in inputs:
        x = x + _embed(emb["type"], inputs["input_type"])
    return run_encoder_stack(params, x, inputs["input_mask"], dims, rng=rng,
                             deterministic=deterministic,
                             compute_dtype=compute_dtype, flash=flash,
                             mesh=mesh, seq_mesh=seq_mesh)


def run_encoder_stack(params, x, input_mask, dims: ModelDims, *, rng=None,
                      deterministic=True, compute_dtype=torch.bfloat16,
                      flash=False, mesh=None, seq_mesh=None):
    """Pre-norm encoder over embedded tokens x (B, L, D). Without
    activation checkpointing: the JAX model rematerialises each layer
    (`jax.checkpoint`) to fit B=128 on a TPU; the flagship's B=64
    activations fit an 80 GB card as they are.

    `seq_mesh` (`parallel.mesh.make_seq_mesh`) ports JAX's `seq_shard`
    hook: the length axis, padded with masked tokens to a multiple of the
    seq group's size, is split over that group. Residuals, layer norms and
    FFNs run on this rank's slice; each attention gathers K/V over the
    group, so `flash_attention` runs Lq = L/n queries against all L keys.
    The whole memory is gathered at the end (differentiably: a caller that
    trains under a seq mesh sums the encoder's gradients over the seq
    group). Its dropout masks are drawn at the padded length, so they are
    not the one-process run's."""
    if seq_mesh is not None:
        L = x.shape[1]
        n = seq_mesh.num_seq
        pad = -L % n
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        input_mask = torch.nn.functional.pad(input_mask, (0, pad),
                                             value=True)
    pad_bias = torch.where(input_mask, NEG_INF, 0.0)[:, None, None, :].to(
        device=x.device, dtype=torch.float32)
    # pads are a suffix (data/packing.py), so a per-row length is an exact
    # stand-in for the pad mask on the flash path
    kv_lengths = (~input_mask).sum(dim=-1).to(torch.int32)
    shards = _rows(mesh)
    if seq_mesh is not None:
        width = x.shape[1] // n
        x = x[:, seq_mesh.seq_rank * width:(seq_mesh.seq_rank + 1) * width]
        shards = ((0, seq_mesh.num_data, seq_mesh.data_rank),
                  (1, n, seq_mesh.seq_rank))
    if not deterministic:
        rng = _default_rng(rng, x.device)
    enc = params["encoder"]
    kw = dict(rng=rng, deterministic=deterministic,
              compute_dtype=compute_dtype, mesh=mesh)
    for lp in _layers(enc, dims.num_encoder_layers):
        h = layer_norm(lp["norm1"], x)
        a = attention(lp["self_attn"], h, h, pad_bias, dims,
                      kv_lengths=kv_lengths, flash=flash, seq_mesh=seq_mesh,
                      **kw)
        x = x + _dropout(rng, a, dims.dropout, deterministic, shards)
        h = layer_norm(lp["norm2"], x)
        f = ffn(lp["ffn"], h, dims, **kw)
        x = x + _dropout(rng, f, dims.dropout, deterministic, shards)
    out = layer_norm(enc["final_norm"], x)
    if seq_mesh is not None:
        out = gather_seq(out, seq_mesh, reduce=False)[:, :L]
    return out


def embed_output(params, output_value, dims: ModelDims):
    """Shifted decoder input embeddings with the zero BOS vector: position
    j >= 1 embeds token j-1 with coord (j-1)%6 and pos (j-1)//6.
    output_value (B, T) -> (B, T+1, D)."""
    emb = params["embed"]
    B, T = output_value.shape
    positions = torch.arange(T, device=output_value.device)
    x = (_embed(emb["value"], output_value)
         + _embed(emb["coord_out"], positions % dims.num_output_dof)[None]
         + _embed(emb["pos_out"], positions // dims.num_output_dof)[None])
    zero = torch.zeros((B, 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    return torch.cat([zero, x], dim=1)


def decode_stack(params, x, memory, self_bias, cross_bias, dims: ModelDims,
                 *, rng=None, deterministic=True, compute_dtype=torch.bfloat16,
                 flash=False, self_lengths=None, cross_lengths=None,
                 mesh=None):
    """Pre-norm decoder stack over full sequences (training path).
    `self_lengths` / `cross_lengths` let the kernels run; they must agree
    with the biases (causal + suffix-pad self-attention, suffix-pad
    cross-attention)."""
    if not deterministic:
        rng = _default_rng(rng, x.device)
    dec = params["decoder"]
    kw = dict(rng=rng, deterministic=deterministic,
              compute_dtype=compute_dtype, mesh=mesh)
    rows = _rows(mesh)
    for lp in _layers(dec, dims.num_decoder_layers):
        h = layer_norm(lp["norm1"], x)
        a = attention(lp["self_attn"], h, h, self_bias, dims,
                      kv_lengths=self_lengths, flash=flash, causal=True, **kw)
        x = x + _dropout(rng, a, dims.dropout, deterministic, rows)
        h = layer_norm(lp["norm2"], x)
        c = attention(lp["cross_attn"], h, memory, cross_bias, dims,
                      kv_lengths=cross_lengths, flash=flash, **kw)
        x = x + _dropout(rng, c, dims.dropout, deterministic, rows)
        h = layer_norm(lp["norm3"], x)
        f = ffn(lp["ffn"], h, dims, **kw)
        x = x + _dropout(rng, f, dims.dropout, deterministic, rows)
    return layer_norm(dec["final_norm"], x)


def train_dists(params, hiddens, dims: ModelDims, eps=1e-6):
    """Log-prob dists over [vocab || pointer], the training branch of the
    reference's `_create_dist`: hiddens (B, S, D) -> (B, S, V+S). Its
    quirks are kept: the pointer triu mask (diagonal included) fills
    *logits* with eps rather than -inf, and the switch probabilities clamp
    at eps before the log."""
    h32 = hiddens.float()
    hp = params["heads"]
    S = hiddens.shape[1]
    vocab_logits = h32 @ hp["vocab"]["w"] + hp["vocab"]["b"]
    pointer_feature = h32 @ hp["pointer"]["w"] + hp["pointer"]["b"]
    pointer_logits = torch.einsum("bsd,btd->bst", pointer_feature, h32)
    pointer_logits = pointer_logits / dims.num_model
    prob = torch.sigmoid(h32 @ hp["switch"]["w"] + hp["switch"]["b"])
    vocab_dists = torch.log_softmax(vocab_logits, dim=-1)
    triu = torch.triu(torch.ones((S, S), dtype=torch.bool,
                                 device=hiddens.device))
    pointer_logits = torch.where(triu[None], eps, pointer_logits)
    pointer_dists = torch.log_softmax(pointer_logits, dim=-1)
    vocab_dists = vocab_dists + torch.log(torch.clamp(1 - prob, min=eps))
    pointer_dists = pointer_dists + torch.log(torch.clamp(prob, min=eps))
    return torch.cat([vocab_dists, pointer_dists], dim=-1)


def token_loss(dists, labels, dims: ModelDims, mesh=None):
    """(loss, {"loss", "accuracy"}) of log-prob dists (B, S, V+S) at
    labels (B, S): the NLL summed over the real tokens over their count.
    With a `mesh`, the count, and the metrics, are the global batch's (sums
    over the data group), so `loss` is this rank's share of the global
    loss and the ranks' gradients sum to its gradient."""
    labels = labels.long()
    valid = labels != dims.pad
    label_logp = torch.gather(dists, -1, labels[..., None])[..., 0]
    count = valid.sum()
    correct = (valid & (dists.argmax(dim=-1) == labels)).sum()
    if mesh is None:
        loss = -(label_logp * valid).sum() / count.clamp(min=1)
        return loss, {"loss": loss, "accuracy": correct / (count + 1e-10)}
    count = all_reduce_sum(count, mesh.data_group)
    loss = -(label_logp * valid).sum() / count.clamp(min=1)
    sums = all_reduce_sum(torch.stack([loss.detach(), correct.float()]),
                          mesh.data_group)
    return loss, {"loss": sums[0], "accuracy": sums[1] / (count + 1e-10)}


def train_step_loss(params, batch, dims: ModelDims, *, rng=None,
                    deterministic=False, compute_dtype=torch.bfloat16,
                    flash=False, mesh=None):
    """Teacher-forced NLL and token accuracy of one batch: (loss,
    {"loss", "accuracy"}), scalar tensors on the batch's device. With a
    `mesh` (`parallel.mesh.make_mesh`), `batch` is this rank's rows and
    `params` its shards, and the metrics are the global batch's
    (`token_loss`)."""
    dev = batch["output_value"].device
    if not deterministic:
        rng = _default_rng(rng, dev)
    inputs = {k: v for k, v in batch.items() if k.startswith("input")}
    memory = encode(params, inputs, dims, rng=rng,
                    deterministic=deterministic, compute_dtype=compute_dtype,
                    flash=flash, mesh=mesh)
    # decoder inputs: tokens shifted right with a zero BOS
    x = embed_output(params, batch["output_value"][:, :-1], dims)
    S = x.shape[1]
    causal = torch.triu(torch.full((S, S), NEG_INF, device=dev),
                        diagonal=1)[None, None]
    # the reference passes output_mask (token positions) as the key-pad
    # mask over embed positions: off by one, kept
    out_mask = batch["output_mask"][:, :S]
    tgt_pad = torch.where(out_mask, NEG_INF, 0.0)[:, None, None, :].float()
    self_bias = causal + tgt_pad
    cross_bias = torch.where(batch["input_mask"], NEG_INF,
                             0.0)[:, None, None, :].float()
    self_lengths = (~out_mask).sum(dim=-1).to(torch.int32)
    cross_lengths = (~batch["input_mask"]).sum(dim=-1).to(torch.int32)
    hiddens = decode_stack(params, x, memory, self_bias, cross_bias, dims,
                           rng=rng, deterministic=deterministic,
                           compute_dtype=compute_dtype, flash=flash,
                           self_lengths=self_lengths,
                           cross_lengths=cross_lengths, mesh=mesh)
    dists = train_dists(params, hiddens, dims)
    return token_loss(dists, batch["output_label"], dims, mesh)


def pointer_structure_mask(dims: ModelDims) -> np.ndarray:
    """(S, S) 0/1 mask of legal attachments: coordinate k of a plank may
    point to coordinate (k+3)%6 of an earlier plank, or to the same
    coordinate of the bbox (row 0); bbox tokens never point."""
    S = dims.max_output_length
    dof = dims.num_output_dof
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    plank2plank = (j % dof) == ((i % dof) + dof // 2) % dof
    plank2bbox = (j % dof) == (i % dof)
    mask = np.where(j < dof, plank2bbox, plank2plank).astype(np.float32)
    mask[:dof, :] = 0.0
    return mask


class PlankModel:
    """Thin wrapper bundling the dims and the functions above."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.dims = ModelDims.from_config(cfg)

    def init(self, seed: int = 0) -> dict:
        return init_params(torch.Generator().manual_seed(seed), self.dims)

    def loss(self, params, batch, rng=None, deterministic=False,
             compute_dtype=torch.bfloat16, flash=False):
        return train_step_loss(params, batch, self.dims, rng=rng,
                               deterministic=deterministic,
                               compute_dtype=compute_dtype, flash=flash)

    def encode(self, params, inputs, deterministic=True,
               compute_dtype=torch.bfloat16, flash=False):
        return encode(params, inputs, self.dims, deterministic=deterministic,
                      compute_dtype=compute_dtype, flash=flash)


def build_model(cfg) -> PlankModel:
    return PlankModel(cfg)
