"""One whole decoder layer for one decode step: the CUDA kernels that
replace the Pallas `plankassembly_tpu/ops/fused_decode.py::
fused_decoder_layer` and `fused_ffn`, and their plain PyTorch versions.

Semantics (both versions), those of the TPU kernel's int8 algorithm; on
x (B, D) f32 with H heads of Dh:

- LN1 (eps 1e-5) -> x @ wqkv + bqkv: the matrix product in the compute
  dtype cd with f32 accumulation, the bias added in f32 (no rounding to cd).
- The new token's K and V are quantized to int8 per (row, head) over Dh
  (`nk`, `nv`, scales `nks`, `nvs`), returned for the caller to write into
  the caches at t. q is quantized per (row, head) too, with sm_scale folded
  into its scale, and scores the int8 cache keys s < t in integer sums
  scaled by the query's and the key's scales. The key at t scores with the
  f32 q against its dequantized k and replaces the stale cache column.
- Softmax over s <= t. The weight pt of the new token stays f32 and
  multiplies its dequantized v. The other weights are multiplied by their
  keys' V scales, then quantized per (row, head) over S, and weigh the int8
  V cache in integer sums.
- wo (+ residual), LN2, the cross query (quantized like q), then
  cross-attention in two passes over chunks of CH = min(128, Li) keys:
  pass 1 takes every score and the row max, pass 2 sums the unquantized
  exp(score - max) into l and quantizes each chunk's weights on their own
  scale before their integer product with the int8 V. The output is scaled
  by v_scale / l, then woc (+ residual).
- `fused_ffn`: LN3 -> w1 -> relu -> w2 (+ residual), products as above.

What is not part of it: the TPU kernel's block-diagonal Qbig/P_big MXU
trick, its row blocks, lane alignment and manual DMA. Every integer sum
here is exact, so the two versions differ only in float rounding order.
The CUDA cross kernel also skips every chunk whose keys all have a bias at
most NEG_INF / 2 when the row has a real key: such a chunk's weights are
exactly 0 in f32 (bias 0 on real keys, NEG_INF = -1e9 on masked ones, as
the decode loop gives), so it adds exactly 0 to l and o.

Cache layouts (the TPU kernel's are in brackets; `tests/
test_torch_fused_decode.py::jax_to_port_layouts` converts):

  k_cache  (B, H, S, Dh) int8   [kt_cache (B, D, S)]
  v_cache  (B, H, Dh, S) int8   [v_cache (B, S, D)]
  ks/vs    (B, H, S) f32        [the same]
  ck       (B, H, Li, Dh) int8  [(B, NCH, D, CH)]
  cv       (B, H, Dh, Li) int8  [(B, NCH, CH, D)]
  cks/cvs  (B, H) f32           [the same]
  cbias    (B, Li) f32          [(NCH, B, CH)]

Each integer product runs along a contiguous axis (Dh for scores, keys for
the weighted sums), four int8 values per 32-bit word.

A CPU tensor goes to the plain version; a CUDA tensor goes to the kernels
in `csrc/fused_decode.cu` or raises.
"""
from __future__ import annotations

import torch

from plankassembly_tpu_torch.models.model import layer_norm
from plankassembly_tpu_torch.ops import _build
from plankassembly_tpu_torch.ops.cross_decode import quantize_rows

# launches of each CUDA entry point (one per call on a CUDA tensor)
layer_launches = 0
ffn_launches = 0


def chunk_width(Li: int) -> int:
    """Keys per cross-attention chunk; part of the result, since each
    chunk's weights are quantized on their own scale."""
    return min(128, Li)


def _ln(x, ln, i):
    """Layer norm i of ln's [scale, bias] row pairs (eps 1e-5)."""
    return layer_norm({"scale": ln[2 * i], "bias": ln[2 * i + 1]}, x)


def _mm(a, w, b, cd):
    """a rounded to cd, times w in cd, summed in f32, plus the f32 bias."""
    return a.to(cd).float() @ w.to(cd).float() + b.float()


def _isum(eq, a, b):
    """Integer sum of products of int8 tensors (exact in float64), as f32."""
    return torch.einsum(eq, a.double(), b.double()).float()


def fused_ffn_reference(x, w1, b1, w2, b2, ln3, *, cd=torch.bfloat16):
    """Plain version of `fused_ffn`."""
    h = _ln(x, ln3, 0)
    z = torch.relu(_mm(h, w1, b1, cd))
    return x + _mm(z, w2, b2, cd)


def cross_scores(q2, ck, cks, cbias, sm_scale):
    """Cross scores of the int8 query (quantized per (row, head)) against
    the int8 keys: (B, H, Li) f32."""
    qi, qs = quantize_rows(q2, (-1,))
    return (_isum("bhd,bhld->bhl", qi, ck) * (qs * sm_scale)
            * cks.float()[..., None] + cbias.float()[:, None, :])


def cross_chunk(sc, m, cv, c0, CH):
    """Chunk [c0, c0 + CH) of the cross weights exp(sc - m): its l (sum of
    the unquantized weights) and o (their int8 product with V, times the
    chunk's weight scale), (B, H, 1) and (B, H, Dh) f32."""
    pc = torch.exp(sc[..., c0:c0 + CH] - m)
    pci, pcs = quantize_rows(pc, (-1,))
    return (pc.sum(dim=-1, keepdim=True),
            _isum("bhj,bhdj->bhd", pci, cv[..., c0:c0 + CH]) * pcs)


def cross_reference(q2, ck, cv, cks, cvs, cbias, sm_scale):
    """Cross-attention of the fused layer, q2 (B, H, Dh) f32 -> (B, H, Dh)
    f32, in two passes over chunks of CH keys: pass 1 takes every score
    and the row max, pass 2 adds each chunk's l and o in chunk order."""
    B, H, Li, Dh = ck.shape
    CH = chunk_width(Li)
    sc = cross_scores(q2, ck, cks, cbias, sm_scale)
    m = sc.amax(dim=-1, keepdim=True)
    l_run = torch.zeros((B, H, 1), dtype=torch.float32, device=q2.device)
    o_run = torch.zeros((B, H, Dh), dtype=torch.float32, device=q2.device)
    for c0 in range(0, Li, CH):
        lc, oc = cross_chunk(sc, m, cv, c0, CH)
        l_run = l_run + lc
        o_run = o_run + oc
    return o_run * (cvs.float()[..., None] / l_run)


def _attention_reference(x, t, wqkv, bqkv, wos, bos, wqc, bqc, woc, boc, ln,
                         k_cache, v_cache, ks_cache, vs_cache, ck, cv, cks,
                         cvs, cbias, H, Dh, sm_scale, cd):
    B, D = x.shape
    S = k_cache.shape[2]
    dev = x.device

    # self-attention over the int8 cache, the new token at t in f32
    qkv = _mm(_ln(x, ln, 0), wqkv, bqkv, cd)
    q, k_t, v_t = (qkv[:, i * D:(i + 1) * D].reshape(B, H, Dh)
                   for i in range(3))
    nk, nks = quantize_rows(k_t, (-1,))
    nv, nvs = quantize_rows(v_t, (-1,))
    own = (q * (nk.float() * nks)).sum(dim=-1) * sm_scale      # (B, H)
    qi, qs = quantize_rows(q, (-1,))
    sc = _isum("bhd,bhsd->bhs", qi, k_cache) * (qs * sm_scale) * ks_cache
    pos = torch.arange(S, device=dev)
    sc = torch.where(pos == t, own[..., None], sc)
    sc = torch.where(pos <= t, sc, torch.tensor(-torch.inf, device=dev))
    p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    pt = p[..., t:t + 1]
    p = torch.where(pos == t, 0.0, p) * vs_cache
    pi, ps = quantize_rows(p, (-1,))
    o = _isum("bhs,bhds->bhd", pi, v_cache) * ps
    o = o + pt * (nv.float() * nvs)
    x = x + _mm(o.reshape(B, D), wos, bos, cd)

    q2 = _mm(_ln(x, ln, 1), wqc, bqc, cd).reshape(B, H, Dh)
    c = cross_reference(q2, ck, cv, cks, cvs, cbias, sm_scale)
    x = x + _mm(c.reshape(B, D), woc, boc, cd)
    return (x, nk.reshape(B, D), nv.reshape(B, D), nks.reshape(B, H),
            nvs.reshape(B, H))


def fused_decoder_layer_reference(x, t, wqkv, bqkv, wos, bos, wqc, bqc, woc,
                                  boc, w1, b1, w2, b2, ln, k_cache, v_cache,
                                  ks_cache, vs_cache, ck, cv, cks, cvs, cbias,
                                  *, H, Dh, sm_scale, cd=torch.bfloat16):
    """Plain version of `fused_decoder_layer` (same arguments)."""
    _check_layer(x, t, ln, k_cache, v_cache, ks_cache, vs_cache, ck, cv, cks,
                 cvs, cbias, H, Dh)
    x_att, nk, nv, nks, nvs = _attention_reference(
        x.float(), int(t), wqkv, bqkv, wos, bos, wqc, bqc, woc, boc,
        ln.float(), k_cache, v_cache, ks_cache.float(), vs_cache.float(), ck,
        cv, cks, cvs, cbias, H, Dh, sm_scale, cd)
    x_out = fused_ffn_reference(x_att, w1, b1, w2, b2, ln[4:6].float(), cd=cd)
    return x_out, nk, nv, nks, nvs


def _check_layer(x, t, ln, k_cache, v_cache, ks_cache, vs_cache, ck, cv, cks,
                 cvs, cbias, H, Dh):
    B, D = x.shape
    if D != H * Dh:
        raise ValueError(f"x width {D} is not H * Dh = {H} * {Dh}")
    S, Li = k_cache.shape[2], ck.shape[2]
    want = {"ln": (ln, (6, D)), "k_cache": (k_cache, (B, H, S, Dh)),
            "v_cache": (v_cache, (B, H, Dh, S)),
            "ks_cache": (ks_cache, (B, H, S)),
            "vs_cache": (vs_cache, (B, H, S)), "ck": (ck, (B, H, Li, Dh)),
            "cv": (cv, (B, H, Dh, Li)), "cks": (cks, (B, H)),
            "cvs": (cvs, (B, H)), "cbias": (cbias, (B, Li))}
    for name, (tensor, shape) in want.items():
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(tensor.shape)}")
    for name in ("k_cache", "v_cache", "ck", "cv"):
        if want[name][0].dtype != torch.int8:
            raise ValueError(f"{name} must be int8")
    if not 0 <= int(t) < S:
        raise ValueError(f"t={int(t)} outside the cache's {S} positions")
    if Li % chunk_width(Li):
        raise ValueError(f"Li={Li} is not a multiple of its chunk width "
                         f"{chunk_width(Li)}")


# ---------------------------------------------------------------------------
# CUDA version
# ---------------------------------------------------------------------------

def _check_device(x, cd):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if cd not in (torch.float32, torch.bfloat16):
        raise ValueError(f"unsupported compute dtype {cd}")


def _gemm_width(n):
    """A width the GEMMs (csrc/gemm_mma.cuh) take as K, N, and as the rows
    of a LayerNorm in their prologue: a multiple of 128 (the norm's 128
    threads, 8 K slices of a multiple of 16), at most 1024 (8 slices of at
    most 128 rows)."""
    return n % 128 == 0 and n <= 1024


def _check_kernel_shapes(Dh, S, Li, D, cd):
    CH = chunk_width(Li)
    if Dh % 16 or CH % 16 or S % 4 or Dh > 128:
        raise ValueError(f"the CUDA kernels copy K/V in 16-byte pieces and "
                         f"sum int8 products four at a time: Dh and the "
                         f"chunk width must be multiples of 16, S of 4, "
                         f"Dh <= 128; got Dh={Dh}, CH={CH}, S={S}")
    if S * 4 > 40 * 1024 or Li // CH > 64:
        raise ValueError(f"the CUDA kernels keep a row's self scores in "
                         f"shared memory and split a row's cross chunks over "
                         f"at most 8 blocks of 8 chunks; S={S}, Li={Li} is "
                         f"too long")
    if not _gemm_width(D):
        raise ValueError(f"the GEMMs normalise rows of a multiple of 128, at "
                         f"most 1024, in their prologue; got D={D}")


def _dev(tensor, dtype, dev):
    return tensor.to(device=dev, dtype=dtype).contiguous()


def fused_ffn(x, w1, b1, w2, b2, ln3, *, cd=torch.bfloat16):
    """LN3 -> w1 -> relu -> w2 -> residual on x (B, D) f32; ln3 (2, D) =
    [scale, bias]. Returns (B, D) f32."""
    global ffn_launches
    if x.device.type == "cpu":
        return fused_ffn_reference(x.float(), w1, b1, w2, b2, ln3.float(),
                                   cd=cd)
    B, D = x.shape
    F = w1.shape[1]
    if tuple(w1.shape) != (D, F) or tuple(w2.shape) != (F, D) or \
            tuple(ln3.shape) != (2, D):
        raise ValueError("fused_ffn: w1 (D, F), w2 (F, D), ln3 (2, D)")
    _check_device(x, cd)
    if not (_gemm_width(D) and _gemm_width(F)):
        raise ValueError(f"the GEMMs take D and F multiples of 128, at most "
                         f"1024; got D={D}, F={F}")
    dev = x.device
    ts = [_dev(x, torch.float32, dev), _dev(w1, cd, dev),
          _dev(b1, torch.float32, dev), _dev(w2, cd, dev),
          _dev(b2, torch.float32, dev), _dev(ln3, torch.float32, dev)]
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    h = torch.empty((B, F), dtype=cd, device=dev)
    code = _build.library().plank_fused_ffn(
        *(t.data_ptr() for t in ts), h.data_ptr(), out.data_ptr(), B, D, F,
        int(cd == torch.bfloat16), _build.stream_handle(dev))
    ffn_launches += 1
    _build.check(code, "plank_fused_ffn")
    return out


def fused_decoder_layer(x, t, wqkv, bqkv, wos, bos, wqc, bqc, woc, boc,
                        w1, b1, w2, b2, ln, k_cache, v_cache, ks_cache,
                        vs_cache, ck, cv, cks, cvs, cbias, *, H, Dh,
                        sm_scale, cd=torch.bfloat16):
    """One decoder layer of one decode step (MHA), then `fused_ffn`.

    x (B, D) f32; t the position; wqkv (D, 3D), bqkv (3D,); wos, wqc, woc
    (D, D) with their (D,) biases; w1, b1, w2, b2 the FFN; ln (6, D) =
    [n1.s, n1.b, n2.s, n2.b, n3.s, n3.b]; the caches and cross K/V in the
    layouts of the module docstring (cache column t is stale). Returns
    (x_out (B, D) f32, nk (B, D) int8, nv (B, D) int8, nks (B, H) f32,
    nvs (B, H) f32)."""
    global layer_launches
    _check_layer(x, t, ln, k_cache, v_cache, ks_cache, vs_cache, ck, cv, cks,
                 cvs, cbias, H, Dh)
    if x.device.type == "cpu":
        return fused_decoder_layer_reference(
            x, t, wqkv, bqkv, wos, bos, wqc, bqc, woc, boc, w1, b1, w2, b2,
            ln, k_cache, v_cache, ks_cache, vs_cache, ck, cv, cks, cvs,
            cbias, H=H, Dh=Dh, sm_scale=sm_scale, cd=cd)
    B, D = x.shape
    S, Li = k_cache.shape[2], ck.shape[2]
    _check_device(x, cd)
    _check_kernel_shapes(Dh, S, Li, D, cd)
    dev = x.device
    f32 = torch.float32
    ins = [_dev(x, f32, dev), _dev(wqkv, cd, dev), _dev(bqkv, f32, dev),
           _dev(wos, cd, dev), _dev(bos, f32, dev), _dev(wqc, cd, dev),
           _dev(bqc, f32, dev), _dev(woc, cd, dev), _dev(boc, f32, dev),
           _dev(ln, f32, dev)]
    caches = [k_cache.contiguous(), v_cache.contiguous(),
              _dev(ks_cache, f32, dev), _dev(vs_cache, f32, dev),
              ck.contiguous(), cv.contiguous(), _dev(cks, f32, dev),
              _dev(cvs, f32, dev), _dev(cbias, f32, dev)]
    if any(c.device != dev for c in caches):
        raise ValueError("every input must lie on x's device")
    x_att = torch.empty((B, D), dtype=f32, device=dev)
    nk = torch.empty((B, D), dtype=torch.int8, device=dev)
    nv = torch.empty((B, D), dtype=torch.int8, device=dev)
    nks = torch.empty((B, H), dtype=f32, device=dev)
    nvs = torch.empty((B, H), dtype=f32, device=dev)
    if B == 0:
        return x_att, nk, nv, nks, nvs
    qkv = torch.empty((B, 3 * D), dtype=f32, device=dev)
    h = torch.empty((B, D), dtype=cd, device=dev)
    x_mid = torch.empty((B, D), dtype=f32, device=dev)
    code = _build.library().plank_fused_layer(
        *(t_.data_ptr() for t_ in ins + caches),
        x_att.data_ptr(), nk.data_ptr(), nv.data_ptr(), nks.data_ptr(),
        nvs.data_ptr(), qkv.data_ptr(), h.data_ptr(), x_mid.data_ptr(),
        B, H, Dh, S, Li, chunk_width(Li),
        int(t), float(sm_scale), int(cd == torch.bfloat16),
        _build.stream_handle(dev))
    layer_launches += 1
    _build.check(code, "plank_fused_layer")
    x_out = fused_ffn(x_att, w1, b1, w2, b2, ln[4:6], cd=cd)
    return x_out, nk, nv, nks, nvs
