"""Greedy decode loop over a precomputed encoder memory: the CUDA version
that replaces the Pallas `plankassembly_tpu/ops/persistent_decode.py::
persistent_greedy_decode`, and its plain PyTorch version.

The TPU kernel runs all S steps in one launch. Here one ctypes call into
`csrc/decode.cu` runs the whole loop: it replays a CUDA graph of
`CHECK_EVERY` consecutive steps until the device's halt flag is set (see
the note there); no kernel waits on a block outside its own cluster. A
decode shape's first call captures that graph; its later calls reuse it
with the shape's stream, events and plan (`LaunchStates`), and every call
of a params object reuses its packed weights (`PreparedWeights`). Two
routes, chosen by `route_of`: in bf16, where the card holds every cluster
of the step's plan at once, each step is one launch (`step`: a
thread-block cluster runs a group of rows through the whole step,
`csrc/decode_step.cu`); otherwise a chain of simple kernels (`chain`:
about 8 a layer), its bf16 products on the tensor cores and its f32 ones
in the SIMT GEMM's order. Each kernel of the loop starts while the
previous one ends (programmatic dependent launch). The step number lives
in device memory, so every replay continues where the last one stopped.
Early exit is that halt flag, which every kernel checks and the host
reads after each replay while the next one runs, so the result (tokens,
trailing tokens of rows that finished earlier, `num_steps`) equals the
JAX while_loop's.

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

import collections
import ctypes
import math
import threading
import weakref

import torch

from plankassembly_tpu_torch.config import ModelDims
from plankassembly_tpu_torch.ops import _build
from plankassembly_tpu_torch.ops.cross_decode import quantize_rows
from plankassembly_tpu_torch.utils import profiling

# calls that ran the CUDA decode (one per decode of a batch), and by route
launches = 0
launches_by_route = {"step": 0, "chain": 0}
# CUDA calls that found their shape's launch state built (hits) or built
# it (misses); `_prepare` calls that found their packed weights, or packed
# them
graph_cache = {"hits": 0, "misses": 0}
weights_cache = {"hits": 0, "misses": 0}
# launch states kept, one a decode shape (device, rows, keys, route, dtype,
# early exit), the least recently used dropped first: the offline callers
# use 2-16 shapes, a serving ladder one a bucket
GRAPH_SHAPES = 16
# packed weight sets kept, one a (params object, dtype, layout, device)
WEIGHT_SETS = 4
# steps in the captured graph: between two host reads of the halt flag
CHECK_EVERY = 8
# the graph of the last CUDA call: capture and instantiate ms (host
# clock, inside the call; 0 on a step route's call that found its shape's
# graph, while the chain captures every call and updates its graph),
# whether the shape's launch state was there (`cached`), kernels a step,
# replays, the replays' ms (CUDA events around them), the route and, on
# the step route, its rows a cluster, cluster size, clusters and the
# clusters the card holds at once
last_graph: dict = {}
# what `csrc/decode.cu::run` writes to its stats (int64): host clock
# readings in ns on the system clock (`time.time_ns()`'s): run entered,
# capture begun, capture ended, graph instantiated or given this call's
# arguments (the replays follow at once), replays launched and the halt
# flag seen, run returned; then graph nodes, replays launched, whether the
# launch state came built, the route (1 step, 0 chain) and the step's plan
# (0 on the chain)
_STATS = ("enter", "capture", "captured", "instantiated", "replayed",
          "returned", "nodes", "replays", "cached", "route", "rows",
          "cluster", "clusters", "held")
# the step's plan (`step_plan`)
_PLAN = ("rows", "cluster", "clusters", "held")


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
               "end_token", "is_bf16", "early_exit", "step")
_PTR_FIELDS = ("wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo", "w1",
               "b1", "w2", "b2", "ln", "final_ln", "head_w", "head_b",
               "emb_value", "emb_coord", "emb_pos", "struct_mask", "ck", "cv",
               "ck_scale", "cv_scale", "mem_mask", "k_cache", "v_cache",
               "h_cache", "x", "hf", "q", "att", "q2", "z", "head_out", "ptr",
               "output", "attach", "done", "halt", "num_steps", "counter")
# the chain's head columns are padded to the cluster GEMM's tile width
_HEAD_TILE = 32
# the chain's scratch between its kernels; the step keeps it in shared
# memory
_CHAIN_SCRATCH = ("x", "hf", "q", "att", "q2", "z", "head_out", "ptr")


def route_of(compute_dtype, plan) -> str:
    """The CUDA decode's route: "step" (one launch a step, products on
    mma.sync) for bf16 where the step's `plan` (`step_plan`; None: the step
    cannot run the shapes) runs every cluster in one wave, else "chain" (52
    kernels a step: bf16 products on mma.sync, f32 products in the SIMT
    GEMM's order). The step's time grows with its rows a cluster and, past
    one wave, with the waves; the chain's kernels spread a large batch over
    every SM (PERF.md §6: on an H100 the step is the faster up to B=128,
    the chain from B=160)."""
    if (compute_dtype == torch.bfloat16 and plan is not None
            and plan["clusters"] <= plan["held"]):
        return "step"
    return "chain"


def _ints(B, Li, dims: ModelDims, cd, early_exit, step):
    """The ints of DecodeArgs."""
    return dict(B=B, S=dims.max_output_length, D=dims.num_model,
                H=dims.num_head, kvH=dims.kv_heads, Dh=dims.head_dim,
                F=dims.num_feedforward, V=dims.vocab_size,
                L=dims.num_decoder_layers, Li=Li, dof=dims.num_output_dof,
                end_token=dims.end, is_bf16=int(cd == torch.bfloat16),
                early_exit=int(early_exit), step=int(step))


def step_plan(B, Li, dims: ModelDims):
    """The step's plan for a bf16 decode of B rows over Li keys on the
    current CUDA device (`csrc/decode.cu::plank_decode_step_plan`): rows a
    cluster, cluster size, clusters and the clusters the card holds at
    once; None where the step cannot run these shapes."""
    args = DecodeArgs(**_ints(B, Li, dims, torch.bfloat16, True, True),
                      **{n: 0 for n in _PTR_FIELDS})
    out = (ctypes.c_int64 * len(_PLAN))()
    if _build.library().plank_decode_step_plan(ctypes.byref(args), out):
        return None
    return dict(zip(_PLAN, out))


def _strips(w, width):
    """(..., K, N) -> (..., N / width, K, width): strips of `width`
    columns over every row, strip-major, as the step kernel streams a
    block's columns in one bulk copy."""
    *lead, K, N = w.shape
    return w.reshape(*lead, K, N // width, width).transpose(-3, -2)


class DecodeArgs(ctypes.Structure):
    """Mirror of `plank::DecodeArgs` in csrc/decode_common.cuh (all fields
    8 bytes)."""

    _fields_ = ([(n, ctypes.c_longlong) for n in _INT_FIELDS]
                + [(n, ctypes.c_void_p) for n in _PTR_FIELDS])


class LaunchStates:
    """Launch state (`csrc/decode.cu::State`: the graph, its stream, events
    and plan) by decode shape, at most `size`, the least recently used
    dropped (`free`) first. A call takes its shape's state out for its
    length (`take`: None where there is none) and gives it back once it
    has succeeded (`give`), so no two calls share one, and a call that
    fails frees what it took or built and leaves the others as they were.
    `counts` holds the takes that found a state (hits) and those that did
    not (misses)."""

    def __init__(self, size, free, counts):
        self.size, self.counts = size, counts
        self._free = free
        self._states = collections.OrderedDict()
        self._lock = threading.Lock()

    def take(self, key):
        with self._lock:
            state = self._states.pop(key, None)
            self.counts["misses" if state is None else "hits"] += 1
        return state

    def give(self, key, state):
        with self._lock:
            dropped = [self._states.pop(key)] if key in self._states else []
            self._states[key] = state
            while len(self._states) > self.size:
                dropped.append(self._states.popitem(last=False)[1])
        for old in dropped:
            self._free(old)

    def keys(self) -> list:
        """The shapes held, the least recently used first."""
        with self._lock:
            return list(self._states)

    def clear(self):
        with self._lock:
            dropped = list(self._states.values())
            self._states.clear()
        for old in dropped:
            self._free(old)


class PreparedWeights:
    """Packed weights by key (params object, dtype, layout, device), at
    most `size` sets. A set is packed again when any of its source tensors
    is another object, or was written in place since (its `_version`, which
    an optimizer's step or a `copy_` under no_grad advances, as between a
    fine-tune's steps and its validation), or moved (`data_ptr`). A key
    keeps only its newest set; the sets whose sources are gone, then the
    least recently used, are dropped first. `counts` holds the lookups
    that found their set (hits) and those that packed it (misses)."""

    def __init__(self, size, counts):
        self.size, self.counts = size, counts
        self._sets = collections.OrderedDict()  # key: (refs, marks, packed)
        self._lock = threading.Lock()

    def get(self, key, sources, pack):
        """The set of `key` over the tensors `sources`, `pack()` where it
        is missing or stale."""
        marks = tuple((t.data_ptr(), t._version) for t in sources)
        with self._lock:
            held = self._sets.get(key)
            if (held is not None and held[1] == marks
                    and all(r() is t for r, t in zip(held[0], sources))):
                self._sets.move_to_end(key)
                self.counts["hits"] += 1
                return held[2]
            self.counts["misses"] += 1
        packed = pack()
        with self._lock:
            self._sets.pop(key, None)
            for gone in [k for k, (refs, _, _) in self._sets.items()
                         if any(r() is None for r in refs)]:
                del self._sets[gone]
            self._sets[key] = ([weakref.ref(t) for t in sources], marks,
                               packed)
            while len(self._sets) > self.size:
                self._sets.popitem(last=False)
        return packed

    def keys(self) -> list:
        with self._lock:
            return list(self._sets)

    def clear(self):
        with self._lock:
            self._sets.clear()


def _free_state(state):
    _build.library().plank_decode_state_free(state)


_launch_states = LaunchStates(GRAPH_SHAPES, _free_state, graph_cache)
_weights = PreparedWeights(WEIGHT_SETS, weights_cache)
# the pointer structure mask on the device, by (model shape, device)
_struct_masks: dict = {}

# the fields of DecodeArgs that `_pack_weights` fills
_WEIGHT_FIELDS = ("wqkv", "bqkv", "wo", "bo", "cwq", "cbq", "cwo", "cbo",
                  "w1", "b1", "w2", "b2", "ln", "final_ln", "head_w",
                  "head_b", "emb_value", "emb_coord", "emb_pos")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _pack_weights(params, dev, cd, step):
    """The decoder's weights, heads and embeddings as the kernels of the
    route read them: products in `cd`, row-major (the chain) or in strips
    (the step); norms, heads and embeddings in f32; and the cross K/V
    projections in `cd`."""
    f32 = torch.float32
    dec, heads, emb = params["decoder"], params["heads"], params["embed"]
    sa, ca, ffn = dec["self_attn"], dec["cross_attn"], dec["ffn"]

    def c(t, dtype):
        return t.to(device=dev, dtype=dtype).contiguous()

    def w(t):  # a product's weights, (L, K, N)
        t = t.to(device=dev, dtype=cd)
        return _strips(t, 8).contiguous() if step else t.contiguous()

    head_w = torch.cat([heads["vocab"]["w"], heads["pointer"]["w"],
                        heads["switch"]["w"]], dim=1).to(device=dev,
                                                          dtype=f32)
    NH = head_w.shape[1]
    if step:
        head_w = _strips(torch.nn.functional.pad(head_w, (0, -NH % 4)), 4)
    else:
        head_w = torch.nn.functional.pad(head_w, (0, -NH % _HEAD_TILE))
    return {
        # `precompute_cross_kv`'s weights, in `cd` (not DecodeArgs')
        "cross_attn": {n: ca[n].to(device=dev, dtype=cd)
                       for n in ("wk", "bk", "wv", "bv")},
        "wqkv": w(torch.cat([sa["wq"], sa["wk"], sa["wv"]], dim=2)),
        "bqkv": c(torch.cat([sa["bq"], sa["bk"], sa["bv"]], dim=1), cd),
        "wo": w(sa["wo"]), "bo": c(sa["bo"], cd),
        "cwq": w(ca["wq"]), "cbq": c(ca["bq"], cd),
        "cwo": w(ca["wo"]), "cbo": c(ca["bo"], cd),
        "w1": w(ffn["w1"]), "b1": c(ffn["b1"], cd),
        "w2": w(ffn["w2"]), "b2": c(ffn["b2"], cd),
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
    }


def _struct_mask(dims: ModelDims, dev):
    """`pointer_structure_mask(dims)` in f32 on `dev`, built once."""
    from plankassembly_tpu_torch.models.model import pointer_structure_mask

    key = (dims, str(dev))
    mask = _struct_masks.get(key)
    if mask is None:
        mask = _struct_masks.setdefault(key, torch.as_tensor(
            pointer_structure_mask(dims)).to(device=dev,
                                             dtype=torch.float32)
            .contiguous())
    return mask


def _prepare(params, memory, memory_mask, dims: ModelDims, cd, early_exit,
             route=None):
    """Device tensors for the kernels of `route` (None: `route_of`'s for
    these shapes on this device): the packed weights (`_pack_weights`,
    once per params object, dtype and layout while its tensors are
    unchanged) and the structure mask (once per model shape and device),
    then this call's own: int8 cross K/V, the pad mask, state at step 0 and
    the chain's scratch. Returns (dict of tensors, ints for DecodeArgs)."""
    from plankassembly_tpu_torch.decode import (
        precompute_cross_kv,
    )

    dev = memory.device
    f32 = torch.float32
    B, Li = memory.shape[0], memory.shape[1]
    S, D, Dh = dims.max_output_length, dims.num_model, dims.head_dim
    kvH, L, F, V = (dims.kv_heads, dims.num_decoder_layers,
                    dims.num_feedforward, dims.vocab_size)
    Dkv, NH = kvH * Dh, V + D + 1

    if route is None:
        route = route_of(cd, step_plan(B, Li, dims)
                         if dev.type == "cuda" and cd == torch.bfloat16
                         else None)
    step = route == "step"
    sources = [t for part in ("decoder", "heads", "embed")
               for t in _leaves(params[part])]
    packed = _weights.get((id(params), cd, step, str(dev)), sources,
                          lambda: _pack_weights(params, dev, cd, step))
    # the same products as on `params` (a cast to `cd` is a no-op here)
    cross_k, cross_v = precompute_cross_kv(
        {"decoder": {"cross_attn": packed["cross_attn"]}}, memory, dims, cd)
    ck_q, ck_s = quantize_rows(cross_k, (2, 4))
    cv_q, cv_s = quantize_rows(cross_v, (2, 4))

    ts = {n: packed[n] for n in _WEIGHT_FIELDS}
    ts["struct_mask"] = _struct_mask(dims, dev)

    def c(t, dtype):
        return t.to(device=dev, dtype=dtype).contiguous()

    ts.update({
        "ck": c(ck_q.reshape(L, B, Li, Dkv), torch.int8),
        "cv": c(cv_q.reshape(L, B, Li, Dkv), torch.int8),
        "ck_scale": c(ck_s.reshape(L, B, kvH), f32),
        "cv_scale": c(cv_s.reshape(L, B, kvH), f32),
        "mem_mask": c(memory_mask, torch.uint8),
        "k_cache": torch.zeros((L, B, S, Dkv), dtype=cd, device=dev),
        "v_cache": torch.zeros((L, B, S, Dkv), dtype=cd, device=dev),
        "h_cache": torch.zeros((B, S, D), dtype=f32, device=dev),
        "output": torch.zeros((B, S), dtype=torch.int32, device=dev),
        "attach": torch.full((B, S), -1, dtype=torch.int32, device=dev),
        "done": torch.zeros((B,), dtype=torch.int32, device=dev),
        "halt": torch.zeros((1,), dtype=torch.int32, device=dev),
        "num_steps": torch.zeros((1,), dtype=torch.int32, device=dev),
        "counter": torch.zeros((1,), dtype=torch.int32, device=dev),
    })
    if not step:
        ts.update({
            "x": torch.zeros((B, D), dtype=f32, device=dev),  # step 0's input
            "hf": torch.empty((B, D), dtype=f32, device=dev),
            "q": torch.empty((B, D), dtype=cd, device=dev),
            "att": torch.empty((B, D), dtype=cd, device=dev),
            "q2": torch.empty((B, D), dtype=cd, device=dev),
            "z": torch.empty((B, F), dtype=cd, device=dev),
            "head_out": torch.empty((B, NH), dtype=f32, device=dev),
            "ptr": torch.empty((B, S), dtype=f32, device=dev),
        })
    return ts, _ints(B, Li, dims, cd, early_exit, step)


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


def _launch_key(device, ints) -> tuple:
    """What a decode's graph depends on besides its tensors' addresses: the
    device, the steps a graph and DecodeArgs' ints (the shapes, dtype,
    route and early exit)."""
    return (str(device), CHECK_EVERY, *ints.values())


def _launch(lib, args, key, stream, num_steps):
    """`lib.plank_decode_run` of `args` on the launch state of `key`
    (`_launch_states`; a new one where it has none, kept once the call has
    succeeded), `stream` the caller's. Returns (the call's stats by name,
    steps run (`num_steps`, a device tensor, read once the call is done),
    the replays' device ns)."""
    state = _launch_states.take(key)
    if state is None:
        state = lib.plank_decode_state_new()
        if not state:
            raise MemoryError("plank_decode_state_new")
    raw = (ctypes.c_int64 * len(_STATS))()
    replay_ns = ctypes.c_int64()
    try:
        _build.check(lib.plank_decode_run(ctypes.byref(args), CHECK_EVERY,
                                          stream, state, raw),
                     "plank_decode_run")
        steps = int(num_steps.item())  # the caller's stream: replays done
        _build.check(lib.plank_decode_replay_ns(state,
                                                ctypes.byref(replay_ns)),
                     "plank_decode_replay_ns")
    except BaseException:
        lib.plank_decode_state_free(state)
        raise
    _launch_states.give(key, state)
    return dict(zip(_STATS, raw)), steps, replay_ns.value


@torch.no_grad()
def persistent_greedy_decode(params, memory, memory_mask, dims: ModelDims, *,
                             compute_dtype=torch.bfloat16, early_exit=True):
    """Greedy decode over encoder memory (B, Li, D) with pad mask (B, Li)
    (True = pad). Returns samples / attach (B, S) int32 tensors, num_steps
    (int) and hidden (B, S, D) f32, the final hidden state of each step
    (zero for steps not run).

    On a CUDA tensor: one call of `csrc/decode.cu`'s loop (a graph of
    `CHECK_EVERY` steps replayed until every row is done) on the route
    `route_of(compute_dtype, batch)`, with the launch state of these shapes
    (`LaunchStates`: built by their first call, reused by the later ones);
    a failed build, capture or launch raises and keeps no launch state. On
    a CPU tensor: `greedy_decode_reference`."""
    global launches
    _check_inputs(memory, memory_mask, dims, compute_dtype)
    if memory.device.type == "cpu":
        return greedy_decode_reference(params, memory, memory_mask, dims,
                                       compute_dtype=compute_dtype,
                                       early_exit=early_exit)
    if memory.device.type != "cuda":
        raise ValueError(f"unsupported device {memory.device}")
    _check_cuda_dims(dims)
    with profiling.annotate("persistent.prepare"):
        ts, ints = _prepare(params, memory, memory_mask, dims,
                            compute_dtype, early_exit)
    args = DecodeArgs(**ints, **{n: ts[n].data_ptr() if n in ts else 0
                                 for n in _PTR_FIELDS})
    launches += 1
    st, num_steps, replay_ns = _launch(
        _build.library(), args, _launch_key(memory.device, ints),
        _build.stream_handle(memory.device), ts["num_steps"])
    route = "step" if st["route"] else "chain"
    launches_by_route[route] += 1
    cached = bool(st["cached"])
    last_graph.clear()
    last_graph.update(capture_ms=(st["captured"] - st["capture"]) / 1e6,
                      instantiate_ms=(st["instantiated"]
                                      - st["captured"]) / 1e6,
                      cached=cached, nodes_per_step=st["nodes"] / CHECK_EVERY,
                      replays=st["replays"], replay_ms=replay_ns / 1e6,
                      route=route, rows_per_cluster=st["rows"],
                      cluster_size=st["cluster"], clusters=st["clusters"],
                      held=st["held"])
    # the call's phases as spans, children of the span open here
    profiling.record("persistent.graph_build", st["enter"],
                     st["instantiated"],
                     nodes_per_step=last_graph["nodes_per_step"], route=route,
                     cached=cached)
    profiling.record("persistent.replay", st["instantiated"],
                     st["replayed"], replays=st["replays"], steps=num_steps,
                     device_ms=last_graph["replay_ms"])
    return {"samples": ts["output"], "attach": ts["attach"],
            "num_steps": num_steps, "hidden": ts["h_cache"]}
