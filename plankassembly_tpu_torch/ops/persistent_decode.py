"""Greedy decode loop over a precomputed encoder memory: the CUDA version
that replaces the Pallas `plankassembly_tpu/ops/persistent_decode.py::
persistent_greedy_decode`, and its plain PyTorch version.

The TPU kernel runs all S steps in one launch. Here one ctypes call into
`csrc/decode.cu` runs the whole loop: it captures `CHECK_EVERY`
consecutive steps of simple kernels (about 8 a layer) once as a CUDA
graph and replays it until the device's halt flag is set (see the note
there); no kernel waits on a block outside its own cluster. The step
number lives in device memory, so every replay continues where the last
one stopped. Early exit is that halt flag, which every kernel checks and
the host reads after each replay while the next one runs, so the result
(tokens, trailing tokens of rows that finished earlier, `num_steps`)
equals the JAX while_loop's.

Semantics (both versions) are those of
``decode.greedy_decode(kv_quant=True, self_quant=False, cross_impl="xla")``
in the JAX package: int8 cross K/V with one scale per (layer, row, kv
head), a self K/V cache in the compute dtype, f32 hidden cache and f32
heads, and the exact `_mixed_sample` tail. The plain version dequantizes
K/V before its products as the JAX path does; the kernels fold the scales
into the scores and the output instead, which only moves rounding.

A CPU tensor goes to `greedy_decode_reference`; a CUDA tensor goes to the
kernels or raises.
"""
from __future__ import annotations

import ctypes
import math

import torch

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.ops import _build
from plankassembly_tpu_torch.ops.cross_decode import quantize_rows

# calls that ran the CUDA decode (one per decode of a batch)
launches = 0
# steps in the captured graph: between two host reads of the halt flag
CHECK_EVERY = 8
# bf16 products run on the tensor cores (mma.sync); True runs them in the
# SIMT GEMM's order of f32 sums instead, as every f32 product runs (for
# comparison)
SIMT_ORDER = False
# each kernel of the loop may start while the previous one ends
# (programmatic dependent launch): its prologue and launch overlap the
# previous kernel's tail
PDL = True
# the graph of the last CUDA call: capture and instantiate ms (host
# clock, inside the call), kernels a step, replays, and the replays' ms
# (CUDA events around them, inside the call)
last_graph: dict = {}


def _layers(tree, L):
    return [{k: v[l] for k, v in tree.items()} for l in range(L)]


@torch.no_grad()
def greedy_decode_reference(params, memory, memory_mask, dims: ModelDims, *,
                            compute_dtype=torch.bfloat16, early_exit=True):
    """Plain PyTorch decode loop; mirrors the JAX package's
    `decode_from_memory(..., kv_quant=True, self_quant=False,
    cross_impl="xla")` operation for operation."""
    from plankassembly_tpu_torch.decode import (
        _mixed_sample, precompute_cross_kv,
    )
    from plankassembly_tpu_torch.models.model import (
        NEG_INF, layer_norm, pointer_structure_mask,
    )

    cd = compute_dtype
    dev = memory.device
    S, H, Dh, D = (dims.max_output_length, dims.num_head, dims.head_dim,
                   dims.num_model)
    kvH, G, L = dims.kv_heads, dims.kv_groups, dims.num_decoder_layers
    Dkv = kvH * Dh
    dof = dims.num_output_dof
    B = memory.shape[0]

    cross_k, cross_v = precompute_cross_kv(params, memory, dims, cd)
    ck_q, ck_s = quantize_rows(cross_k, (2, 4))
    cv_q, cv_s = quantize_rows(cross_v, (2, 4))
    cross_bias = torch.where(memory_mask.to(dev), NEG_INF, 0.0)[:, None, None, :]

    dec, heads = params["decoder"], params["heads"]
    sa_l = _layers(dec["self_attn"], L)
    ca_l = _layers(dec["cross_attn"], L)
    ffn_l = _layers(dec["ffn"], L)
    n1_l, n2_l, n3_l = (_layers(dec[n], L) for n in ("norm1", "norm2", "norm3"))
    wqkv_l = [torch.cat([p["wq"], p["wk"], p["wv"]], dim=1).to(cd) for p in sa_l]
    bqkv_l = [torch.cat([p["bq"], p["bk"], p["bv"]]).to(cd) for p in sa_l]

    def mm(x, w, b):
        return x.to(cd) @ w.to(cd) + b.to(cd)

    def scores_of(q, k):  # q (B,1,H,Dh), k (B,T,kvH,Dh) -> (B,H,1,T) f32
        k = k.repeat_interleave(G, dim=2) if G > 1 else k
        return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())

    def out_of(w, v):  # w (B,H,1,T) cd, v (B,T,kvH,Dh) -> (B,1,H,Dh) f32
        v = v.repeat_interleave(G, dim=2) if G > 1 else v
        return torch.einsum("bhqk,bkhd->bqhd", w.float(), v.float())

    struct = torch.as_tensor(pointer_structure_mask(dims), device=dev)
    scale = 1.0 / math.sqrt(Dh)
    k_cache = torch.zeros((L, B, S, kvH, Dh), dtype=cd, device=dev)
    v_cache = torch.zeros((L, B, S, kvH, Dh), dtype=cd, device=dev)
    h_cache = torch.zeros((B, S, D), dtype=torch.float32, device=dev)
    output = torch.zeros((B, S), dtype=torch.int32, device=dev)
    attach = torch.full((B, S), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    emb = params["embed"]
    pos = torch.arange(S, device=dev)

    t = 0
    while t < S and not (early_exit and bool(done.all())):
        if t == 0:
            x = torch.zeros((B, 1, D), dtype=emb["value"].dtype, device=dev)
        else:
            prev = output[:, t - 1].long()
            x = (emb["value"][prev] + emb["coord_out"][(t - 1) % dof][None]
                 + emb["pos_out"][(t - 1) // dof][None])[:, None, :]
        self_bias = torch.where(pos <= t, 0.0, NEG_INF)[None, None, None, :]
        for l in range(L):
            h = layer_norm(n1_l[l], x)
            qkv = mm(h, wqkv_l[l], bqkv_l[l])[:, 0]
            q = qkv[:, :D].reshape(B, 1, H, Dh)
            k_cache[l, :, t] = qkv[:, D:D + Dkv].reshape(B, kvH, Dh)
            v_cache[l, :, t] = qkv[:, D + Dkv:].reshape(B, kvH, Dh)
            w = torch.softmax(scores_of(q, k_cache[l]) * scale + self_bias, -1)
            a = out_of(w.to(cd), v_cache[l]).reshape(B, 1, D)
            a = mm(a, sa_l[l]["wo"], sa_l[l]["bo"])
            x = x + a.to(x.dtype)

            h = layer_norm(n2_l[l], x)
            q2 = mm(h, ca_l[l]["wq"], ca_l[l]["bq"]).reshape(B, 1, H, Dh)
            ck = ck_q[l].to(cd) * ck_s[l].to(cd)
            cv = cv_q[l].to(cd) * cv_s[l].to(cd)
            w = torch.softmax(scores_of(q2, ck) * scale + cross_bias, -1)
            c = out_of(w.to(cd), cv).reshape(B, 1, D)
            c = mm(c, ca_l[l]["wo"], ca_l[l]["bo"])
            x = x + c.to(x.dtype)

            h = layer_norm(n3_l[l], x)
            z = torch.relu(mm(h, ffn_l[l]["w1"], ffn_l[l]["b1"]))
            z = mm(z, ffn_l[l]["w2"], ffn_l[l]["b2"])
            x = x + z.to(x.dtype)

        h_t = layer_norm(dec["final_norm"], x)[:, 0].float()
        h_cache[:, t] = h_t
        _mixed_sample(heads, dims, struct, pos, h_t, h_cache, output, attach,
                      done, t)
        t += 1
    return {"samples": output, "attach": attach, "num_steps": t,
            "hidden": h_cache}


# ---------------------------------------------------------------------------
# CUDA version
# ---------------------------------------------------------------------------

_INT_FIELDS = ("B", "S", "D", "H", "kvH", "Dh", "F", "V", "L", "Li", "dof",
               "end_token", "is_bf16", "early_exit", "simt_order", "pdl")
_PTR_FIELDS = ("wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo", "w1",
               "b1", "w2", "b2", "ln", "final_ln", "head_w", "head_b",
               "emb_value", "emb_coord", "emb_pos", "struct_mask", "ck", "cv",
               "ck_scale", "cv_scale", "mem_mask", "k_cache", "v_cache",
               "h_cache", "x", "hf", "q", "att", "q2", "z", "head_out", "ptr",
               "output", "attach", "done", "halt", "num_steps", "counter")
# the head's columns are padded to the cluster GEMM's tile width
_HEAD_TILE = 32


class DecodeArgs(ctypes.Structure):
    """Mirror of `plank::DecodeArgs` in csrc/decode.cu (all fields 8 bytes)."""

    _fields_ = ([(n, ctypes.c_longlong) for n in _INT_FIELDS]
                + [(n, ctypes.c_void_p) for n in _PTR_FIELDS])


def _prepare(params, memory, memory_mask, dims: ModelDims, cd, early_exit):
    """Device tensors for the kernels: packed weights, int8 cross K/V,
    state at step 0 and scratch. Returns (dict of tensors, ints for
    DecodeArgs)."""
    from plankassembly_tpu_torch.decode import (
        precompute_cross_kv,
    )
    from plankassembly_tpu_torch.models.model import pointer_structure_mask

    dev = memory.device
    f32 = torch.float32
    B, Li = memory.shape[0], memory.shape[1]
    S, D, H, Dh = (dims.max_output_length, dims.num_model, dims.num_head,
                   dims.head_dim)
    kvH, L, F, V = (dims.kv_heads, dims.num_decoder_layers,
                    dims.num_feedforward, dims.vocab_size)
    Dkv, NH = kvH * Dh, V + D + 1
    dec, heads, emb = params["decoder"], params["heads"], params["embed"]
    sa, ca, ffn = dec["self_attn"], dec["cross_attn"], dec["ffn"]

    cross_k, cross_v = precompute_cross_kv(params, memory, dims, cd)
    ck_q, ck_s = quantize_rows(cross_k, (2, 4))
    cv_q, cv_s = quantize_rows(cross_v, (2, 4))

    def c(t, dtype):
        return t.to(device=dev, dtype=dtype).contiguous()

    head_w = torch.cat([heads["vocab"]["w"], heads["pointer"]["w"],
                        heads["switch"]["w"]], dim=1)
    head_w = torch.nn.functional.pad(head_w, (0, -NH % _HEAD_TILE))
    ts = {
        "wqkv": c(torch.cat([sa["wq"], sa["wk"], sa["wv"]], dim=2), cd),
        "bqkv": c(torch.cat([sa["bq"], sa["bk"], sa["bv"]], dim=1), cd),
        "wo": c(sa["wo"], cd), "bo": c(sa["bo"], cd),
        "cwq": c(ca["wq"], cd), "cbq": c(ca["bq"], cd),
        "cwo": c(ca["wo"], cd), "cbo": c(ca["bo"], cd),
        "w1": c(ffn["w1"], cd), "b1": c(ffn["b1"], cd),
        "w2": c(ffn["w2"], cd), "b2": c(ffn["b2"], cd),
        "ln": c(torch.stack([dec[n][k] for n in ("norm1", "norm2", "norm3")
                             for k in ("scale", "bias")], dim=1), f32),
        "final_ln": c(torch.stack([dec["final_norm"]["scale"],
                                   dec["final_norm"]["bias"]]), f32),
        "head_w": c(head_w, f32),
        "head_b": c(torch.cat([heads["vocab"]["b"], heads["pointer"]["b"],
                               heads["switch"]["b"]]), f32),
        "emb_value": c(emb["value"], f32),
        "emb_coord": c(emb["coord_out"], f32),
        "emb_pos": c(emb["pos_out"], f32),
        "struct_mask": c(torch.as_tensor(pointer_structure_mask(dims)), f32),
        "ck": c(ck_q.reshape(L, B, Li, Dkv), torch.int8),
        "cv": c(cv_q.reshape(L, B, Li, Dkv), torch.int8),
        "ck_scale": c(ck_s.reshape(L, B, kvH), f32),
        "cv_scale": c(cv_s.reshape(L, B, kvH), f32),
        "mem_mask": c(memory_mask, torch.uint8),
        "k_cache": torch.zeros((L, B, S, Dkv), dtype=cd, device=dev),
        "v_cache": torch.zeros((L, B, S, Dkv), dtype=cd, device=dev),
        "h_cache": torch.zeros((B, S, D), dtype=f32, device=dev),
        "x": torch.zeros((B, D), dtype=f32, device=dev),  # step 0's input
        "hf": torch.empty((B, D), dtype=f32, device=dev),
        "q": torch.empty((B, D), dtype=cd, device=dev),
        "att": torch.empty((B, D), dtype=cd, device=dev),
        "q2": torch.empty((B, D), dtype=cd, device=dev),
        "z": torch.empty((B, F), dtype=cd, device=dev),
        "head_out": torch.empty((B, NH), dtype=f32, device=dev),
        "ptr": torch.empty((B, S), dtype=f32, device=dev),
        "output": torch.zeros((B, S), dtype=torch.int32, device=dev),
        "attach": torch.full((B, S), -1, dtype=torch.int32, device=dev),
        "done": torch.zeros((B,), dtype=torch.int32, device=dev),
        "halt": torch.zeros((1,), dtype=torch.int32, device=dev),
        "num_steps": torch.zeros((1,), dtype=torch.int32, device=dev),
        "counter": torch.zeros((1,), dtype=torch.int32, device=dev),
    }
    ints = dict(B=B, S=S, D=D, H=H, kvH=kvH, Dh=Dh, F=F, V=V, L=L, Li=Li,
                dof=dims.num_output_dof, end_token=dims.end,
                is_bf16=int(cd == torch.bfloat16), early_exit=int(early_exit),
                simt_order=int(SIMT_ORDER), pdl=int(PDL))
    return ts, ints


def _check_inputs(memory, memory_mask, dims: ModelDims, cd):
    if memory.dim() != 3 or memory.shape[2] != dims.num_model:
        raise ValueError(f"memory must be (B, Li, {dims.num_model}), got "
                         f"{tuple(memory.shape)}")
    if memory_mask.shape != memory.shape[:2]:
        raise ValueError(f"memory_mask must be {tuple(memory.shape[:2])}, "
                         f"got {tuple(memory_mask.shape)}")
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {cd}")


def _check_cuda_dims(dims: ModelDims):
    """The model shapes csrc/decode.cu's kernels take, as a readable error
    before anything is prepared. `valid` there guards the same limits and
    the bucket's; a call past them returns cudaErrorInvalidValue, which
    raises."""
    G, Dh, D, F = (dims.kv_groups, dims.head_dim, dims.num_model,
                   dims.num_feedforward)
    if not (G <= 8 and Dh in (32, 64, 128) and D % 128 == 0
            and D <= 1024 and F % 128 == 0 and F <= 1024):
        raise ValueError(
            f"the CUDA decode takes kv groups <= 8, head dims 32, 64 or 128, "
            f"and model and feed-forward widths that are multiples of 128 up "
            f"to 1024; got G={G}, Dh={Dh}, D={D}, F={F}")


@torch.no_grad()
def persistent_greedy_decode(params, memory, memory_mask, dims: ModelDims, *,
                             compute_dtype=torch.bfloat16, early_exit=True):
    """Greedy decode over encoder memory (B, Li, D) with pad mask (B, Li)
    (True = pad). Returns samples / attach (B, S) int32 tensors, num_steps
    (int) and hidden (B, S, D) f32, the final hidden state of each step
    (zero for steps not run).

    On a CUDA tensor: one call of `csrc/decode.cu`'s loop (a graph of
    `CHECK_EVERY` steps captured for this call and replayed until every row
    is done), with the bf16 products on the tensor cores unless
    `SIMT_ORDER`; a failed build, capture or launch raises. On a CPU tensor:
    `greedy_decode_reference`."""
    global launches
    _check_inputs(memory, memory_mask, dims, compute_dtype)
    if memory.device.type == "cpu":
        return greedy_decode_reference(params, memory, memory_mask, dims,
                                       compute_dtype=compute_dtype,
                                       early_exit=early_exit)
    if memory.device.type != "cuda":
        raise ValueError(f"unsupported device {memory.device}")
    _check_cuda_dims(dims)
    ts, ints = _prepare(params, memory, memory_mask, dims, compute_dtype,
                        early_exit)
    args = DecodeArgs(**ints, **{n: ts[n].data_ptr() for n in _PTR_FIELDS})
    lib = _build.library()
    stream = _build.stream_handle(memory.device)
    stats = (ctypes.c_double * 5)()
    launches += 1
    _build.check(lib.plank_decode_run(ctypes.byref(args), CHECK_EVERY,
                                      stream, stats), "plank_decode_run")
    last_graph.clear()
    last_graph.update(capture_ms=stats[0], instantiate_ms=stats[1],
                      nodes_per_step=stats[2] / CHECK_EVERY,
                      replays=int(stats[3]), replay_ms=stats[4])
    return {"samples": ts["output"], "attach": ts["attach"],
            "num_steps": int(ts["num_steps"].item()), "hidden": ts["h_cache"]}
