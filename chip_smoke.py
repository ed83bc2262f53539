#!/usr/bin/env python3
"""Drive the PyTorch port's serving main path on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each under a watchdog that ends the run with a stack trace
instead of hanging, each printing one line (or a few) when it ends:

1. device: the card's name and power limit, and the nvcc build of the
   kernels in plankassembly_tpu_torch/csrc (build seconds, registers);
2. flash_attention (CUDA) against its plain version at encoder shapes:
   B=64, H=8, L=1280, ragged lengths, causal and not, bf16 and f32; and at
   the main path's own shape (the 32-program request: grouped-query K/V,
   the fixture's lengths, bucket width); kernel, plain and
   scaled_dot_product_attention times (the last a yardstick only);
3. the decode kernels against their plain version on the flagship
   checkpoint and the fixture's encoder memory, in bf16: token agreement,
   F1 of each, time per step;
4. the main path: load checkpoints/gqa_complete_ep221.npz, pack the 64
   fixture drawings, serve them through make_live_backend + BatchingServer
   as requests of 8, 24 and 32 programs, and score P/R/F1 against the
   fixture's ground truth, in bf16 (the serving setting) and f32, beside
   the JAX reference's golden F1; launches of each kernel on that path.

It then prints the kernels' JSON line, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Any failed check exits non-zero
before that line. Without CUDA it exits non-zero and prints no result.
"""
import faulthandler
import gzip
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "gqa_complete_ep221.npz")
FIXTURES = os.path.join(ROOT, "plankassembly_tpu_torch", "fixtures")
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet), for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# watchdog budget of each phase, seconds
BUDGET = {"device": 240, "flash": 180, "decode": 240, "serve": 300}

# tolerances (the plain versions accumulate in f32 like the kernels; the
# kernels' exp and summation order differ)
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DECODE_F1_TOL = 0.005          # kernel vs plain, bf16, same memory
SERVE_F1_TOL = {"bf16": 0.01, "f32": 0.002}  # port vs the JAX golden
REQUESTS = (8, 24, 32)         # programs per request on the main path


class CheckFailed(Exception):
    pass


def check(ok, what):
    if not ok:
        raise CheckFailed(what)


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, reps=10, warmup=2):
    """Mean device time of fn() in ms (CUDA events around `reps` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        faulthandler.dump_traceback_later(BUDGET[self.name], exit=True)
        return self

    def __exit__(self, *exc):
        faulthandler.cancel_dump_traceback_later()
        if exc[0] is None:
            log(f"[{self.name}] done in {time.perf_counter() - self.t0:.1f} s")
        return False


# ---------------------------------------------------------------- phase 2
def _sdpa(q, k, v, mask):
    """One PyTorch call for the same attention (a yardstick only; the port
    never calls it)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(q, k, v, attn_mask=mask,
                        enable_gqa=k.shape[1] != q.shape[1])


def flash_case(B, H, Hkv, L, lengths, causal, dtype, seed, timing=False):
    from plankassembly_tpu_torch.ops import attention as A
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn((B, H, L, 64), generator=g, device=DEVICE).to(dtype)
    k = torch.randn((B, Hkv, L, 64), generator=g, device=DEVICE).to(dtype)
    v = torch.randn((B, Hkv, L, 64), generator=g, device=DEVICE).to(dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=DEVICE)
    got = A.flash_attention(q, k, v, lens, causal=causal)
    ref = A.flash_attention_reference(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    check(torch.isfinite(got.float()).all().item(), "flash output not finite")
    res = {"err": err}
    if timing:
        res["ms"] = cuda_ms(lambda: A.flash_attention(q, k, v, lens,
                                                      causal=causal))
        res["plain_ms"] = cuda_ms(lambda: A.flash_attention_reference(
            q, k, v, lens, causal=causal), reps=3, warmup=1)
        col = torch.arange(L, device=DEVICE)
        mask = (col[None, :] < lens[:, None])[:, None, None, :]
        if causal:
            mask = mask & (col[None, :] <= col[:, None])[None, None]
        res["library_ms"] = cuda_ms(_sdpa(q, k, v, mask))
        # bound: q, k, v and lengths read once, out written once; the
        # products the lengths (and the causal triangle) leave
        nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * \
            q.element_size() + lens.numel() * 4
        keys = torch.clamp(lens.double(), max=L)[:, None].expand(B, L)
        if causal:
            keys = torch.minimum(keys, torch.arange(1, L + 1, device=DEVICE,
                                                    dtype=torch.float64))
        flops = 4.0 * 64 * H * keys.sum().item()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype] * 1e3
        res["bound_ms"] = max(t_bytes, t_ops)
        res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return res


def phase_flash(main_lengths, bucket):
    rng = np.random.default_rng(0)
    lengths64 = np.concatenate([[1280, 1, 640],
                                rng.integers(1, 1281, 61)]).astype(np.int32)
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            r = flash_case(64, 8, 8, 1280, lengths64, causal, dtype,
                           seed=1 + causal)
            tag = f"flash B=64 H=8 L=1280 ragged {str(dtype)[6:]} " \
                  f"causal={causal}"
            log(f"{tag}: max_abs_err {r['err']:.3e} "
                f"(tol {FLASH_TOL[dtype]:g})")
            check(r["err"] <= FLASH_TOL[dtype], f"{tag} disagrees")
    # the main path's shape: the 32-program request at the serving bucket,
    # grouped-query K/V (2 kv heads), the fixture's real lengths
    r = flash_case(len(main_lengths), 8, 2, bucket, main_lengths,
                   False, torch.bfloat16, seed=3, timing=True)
    log(f"flash main-path shape B={len(main_lengths)} H=8 Hkv=2 L={bucket} "
        f"bf16: max_abs_err {r['err']:.3e}; kernel {r['ms']:.3f} ms, plain "
        f"{r['plain_ms']:.3f} ms, sdpa {r['library_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    check(r["err"] <= FLASH_TOL[torch.bfloat16], "flash main shape disagrees")
    return r


# ---------------------------------------------------------------- phase 3
def decode_bound(dims, params, memory, mask, steps, cd):
    """Least time for persistent_greedy_decode on these inputs. Bytes: the
    real (unmasked) memory rows and the mask read once, each parameter the
    kernels read once at the dtype they read it (the decoder's products
    in the compute dtype, norms, heads and embeddings in f32), the outputs
    written once. Operations: the cross K/V projection of the real memory
    rows, each step's per-row products, self-attention over the keys so
    far, cross-attention over each row's real keys (masked keys add exactly
    0), and the pointer logits; the heads and pointer logits in f32, the
    rest in the compute dtype."""
    D, F, L, V, S = (dims.num_model, dims.num_feedforward,
                     dims.num_decoder_layers, dims.vocab_size,
                     dims.max_output_length)
    Dkv, H, Dh = dims.kv_heads * dims.head_dim, dims.num_head, dims.head_dim
    B = memory.shape[0]
    real = int((~mask.bool()).sum().item())       # real memory rows, all rows
    cd_size = torch.tensor([], dtype=cd).element_size()
    dec = params["decoder"]
    nparam = sum(t.numel() for n in ("self_attn", "cross_attn", "ffn")
                 for t in dec[n].values()) * cd_size
    nparam += 4 * sum(t.numel() for n in ("norm1", "norm2", "norm3",
                                          "final_norm")
                      for t in dec[n].values())
    nparam += 4 * sum(t.numel() for t in _leaves(params["heads"]))
    nparam += 4 * sum(params["embed"][n].numel()
                      for n in ("value", "coord_out", "pos_out"))
    nbytes = (real * D * memory.element_size() + mask.numel() + nparam
              + 2 * B * S * 4)
    proj = 2.0 * real * D * 2 * Dkv * L
    layers = 2.0 * L * (D * (D + 2 * Dkv) + 3 * D * D + 2 * D * F)
    attn = sum(B * L * 4.0 * H * Dh * (t + 1) + L * 4.0 * H * Dh * real
               for t in range(steps))
    low = proj + B * steps * layers + attn             # compute dtype
    f32 = sum(B * (2.0 * D * (V + D + 1) + 2.0 * D * t)
              for t in range(steps))                   # heads, pointers
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (low / PEAK_FLOPS[cd] + f32 / PEAK_FLOPS[torch.float32]) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_decode(params, dims, batch, gt, bucket):
    from plankassembly_tpu_torch.decode import _pad_or_crop
    from plankassembly_tpu_torch.metrics import batch_scores
    from plankassembly_tpu_torch.models.model import encode
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    cd = torch.bfloat16
    inputs = _pad_or_crop({k: v for k, v in batch.items()}, bucket, dims)
    with torch.no_grad():
        memory = encode(params, inputs, dims, compute_dtype=cd, flash=True)
    mask = inputs["input_mask"]
    B, Li = memory.shape[:2]

    def kern():
        return PD.persistent_greedy_decode(params, memory, mask, dims,
                                           compute_dtype=cd)

    def plain():
        return PD.greedy_decode_reference(params, memory, mask, dims,
                                          compute_dtype=cd)

    k_out, p_out = kern(), plain()
    torch.cuda.synchronize()
    ks, ps = k_out["samples"].cpu(), p_out["samples"].cpu()
    agree = (ks == ps).float().mean().item()
    same = (ks == ps).all(dim=1)
    steps = min(k_out["num_steps"], p_out["num_steps"])
    check(bool(same.any()), "decode: no row identical to the plain version")
    sel = same.to(DEVICE)
    attach_same = bool((k_out["attach"][sel] == p_out["attach"][sel]).all())
    hid_err = (k_out["hidden"][sel, :steps]
               - p_out["hidden"][sel, :steps]).abs().max().item()
    f1_k = batch_scores(ks, gt)[2].mean().item()
    f1_p = batch_scores(ps, gt)[2].mean().item()

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, out["num_steps"]

    k_ms, k_steps = timed(kern, 3)
    p_ms, p_steps = timed(plain, 2)
    bound_ms, bound_by = decode_bound(dims, params, memory, mask,
                                       k_steps, cd)
    log(f"decode B={B} Li={Li} bf16: token agreement {agree:.4f}, identical "
        f"rows {same.float().mean().item():.3f}, hidden max_abs_err on "
        f"identical rows {hid_err:.3e}, attach equal on identical rows "
        f"{attach_same}; F1 kernel {f1_k:.6f} plain {f1_p:.6f}; kernel {k_ms:.2f} ms ({k_steps} steps, "
        f"{k_ms / k_steps:.3f} ms/step), plain {p_ms:.2f} ms ({p_steps} "
        f"steps, {p_ms / p_steps:.3f} ms/step); bound {bound_ms:.4f} ms "
        f"({bound_by})")
    check(abs(f1_k - f1_p) <= DECODE_F1_TOL,
          f"decode F1 kernel {f1_k} vs plain {f1_p}")
    check(agree >= 0.9, f"decode token agreement {agree}")
    check(attach_same, "decode: attach differs from the plain version on "
          "rows with identical tokens")
    return {"err": hid_err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


# ---------------------------------------------------------------- phase 4
def serve(params, cfg, packed, bucket, cd):
    """All fixture drawings through BatchingServer as requests of
    REQUESTS programs (each request's programs submitted concurrently).
    Returns (samples, attach (N, S) numpy, backend stats, wall seconds)."""
    from plankassembly_tpu_torch.serving import (
        BatchingServer, make_live_backend,
    )

    backend, meta = make_live_backend(params, cfg, batch=max(REQUESTS),
                                      bucket=bucket, compute_dtype=cd,
                                      device=DEVICE)
    stats = {"seconds": 0.0, "steps": 0, "calls": 0}

    def timed_backend(request):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = backend(request)
        torch.cuda.synchronize()
        stats["seconds"] += time.perf_counter() - t0
        stats["steps"] += int(out["num_steps"])
        stats["calls"] += 1
        return out

    server = BatchingServer(timed_backend, meta, max_wait_ms=200)
    rows = [None] * len(packed)
    t0 = time.perf_counter()
    try:
        first = 0
        for n in REQUESTS:
            def ask(i):
                rows[i] = server.submit(
                    {k: v for k, v in packed[i].items()}, timeout=120)
            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(first, first + n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=150)
            check(not any(t.is_alive() for t in threads),
                  "a request did not come back")
            first += n
    finally:
        server.close()
    wall = time.perf_counter() - t0
    check(all(r is not None for r in rows), "a request failed")
    samples = np.stack([r["samples"] for r in rows])
    attach = np.stack([r["attach"] for r in rows])
    return samples, attach, stats, wall


def phase_serve(params, cfg, dims, packed, gt, golden, bucket):
    from plankassembly_tpu_torch.metrics import batch_scores
    from plankassembly_tpu_torch.ops import attention as A
    from plankassembly_tpu_torch.ops import persistent_decode as PD

    results = {}
    for name, cd in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        A.launches = 0
        PD.launches = 0
        samples, attach, stats, wall = serve(params, cfg, packed, bucket, cd)
        counts = {"flash_attention": A.launches,
                  "persistent_greedy_decode": PD.launches}
        check(samples.shape == (len(packed), dims.max_output_length),
              f"samples shape {samples.shape}")
        prec, rec, f1 = batch_scores(torch.from_numpy(samples), gt)
        gold = golden[f"samples_{name}"]
        same = [np.array_equal(_upto_end(a, dims.end), _upto_end(b, dims.end))
                for a, b in zip(samples, gold)]
        identical = float(np.mean(same))
        # pointers of identical programs, over the program's tokens
        gold_attach = golden[f"attach_{name}"]
        attach_bad = []
        for i in np.flatnonzero(same):
            n = len(_upto_end(samples[i], dims.end))
            if not np.array_equal(attach[i, :n], gold_attach[i, :n]):
                attach_bad.append(int(i))
        f1m, gold_f1 = f1.mean().item(), float(golden[f"f1_{name}"].mean())
        log(f"serve {name}: {len(packed)} programs in {stats['calls']} "
            f"batches ({'/'.join(map(str, REQUESTS))}): P {prec.mean():.6f} "
            f"R {rec.mean():.6f} F1 {f1m:.6f} vs JAX golden F1 {gold_f1:.6f} "
            f"(tol {SERVE_F1_TOL[name]}); identical programs {identical:.4f}, "
            f"their attach equal to the golden {not attach_bad}; "
            f"{len(packed) / wall:.2f} programs/s wall (with the server's "
            f"batching waits), {len(packed) / stats['seconds']:.2f} "
            f"programs/s in the backend; backend {stats['seconds'] * 1e3:.1f} "
            f"ms over {stats['steps']} steps = "
            f"{stats['seconds'] * 1e3 / stats['steps']:.3f} ms/step; "
            f"launches {counts}")
        check(abs(f1m - gold_f1) <= SERVE_F1_TOL[name],
              f"serve {name} F1 {f1m} vs golden {gold_f1}")
        check(not attach_bad, f"serve {name}: attach differs from the JAX "
              f"golden on identical programs {attach_bad}")
        check(all(c > 0 for c in counts.values()),
              f"a kernel did not run on the main path: {counts}")
        results[name] = counts
    return results


def _upto_end(row, end):
    hits = np.flatnonzero(row == end)
    return row[: hits[0] + 1] if hits.size else row


# ------------------------------------------------------------------- main
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    from plankassembly_tpu_torch.checkpoint import load_checkpoint
    from plankassembly_tpu_torch.config import ModelDims
    from plankassembly_tpu_torch.ops import _build
    from plankassembly_tpu_torch.serving import pack_info_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("device"):
        card = card_line()
        log(f"card: {card}; torch {torch.__version__} cuda "
            f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)} "
            f"x{torch.cuda.device_count()}")
        _build.library()
        built = ("found already built" if _build.build_seconds is None
                 else f"built in {_build.build_seconds:.1f} s")
        log(f"kernels {built} (nvcc {' '.join(_build.NVCC_FLAGS)})")
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line and " 0 bytes" not in line:
                log("  ptxas:", line.strip())

    params, cfg = load_checkpoint(CKPT, device=DEVICE)
    dims = ModelDims.from_config(cfg)
    with gzip.open(os.path.join(FIXTURES, "serve64.json.gz"), "rt") as f:
        infos = json.load(f)
    golden = np.load(os.path.join(FIXTURES, "serve64_jax_golden.npz"))
    bucket = int(golden["bucket"])
    gt = torch.from_numpy(golden["gt_samples"])
    packed = [{k: v for k, v in pack_info_dict(info, cfg).items()}
              for info in infos]
    # the main path's largest request: the last 32 programs
    last = slice(len(packed) - max(REQUESTS), len(packed))
    req = {k: torch.from_numpy(np.stack([p[k] for p in packed[last]]))
           .to(DEVICE) for k in packed[0]}
    main_lengths = (~req["input_mask"]).sum(dim=1).cpu().numpy()

    with Phase("flash"):
        flash = phase_flash(main_lengths, bucket)
    with Phase("decode"):
        decode = phase_decode(params, dims, req, gt[last], bucket)
    with Phase("serve"):
        launches = phase_serve(params, cfg, dims, packed, gt, golden, bucket)

    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "plankassembly_tpu_torch/csrc/attention.cu",
         "replaces": "plankassembly_tpu/ops/attention.py:95",
         "launches": launches["bf16"]["flash_attention"],
         "max_abs_err": flash["err"], "ms": flash["ms"],
         "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
         "bound_by": flash["bound_by"], "library_ms": flash["library_ms"]},
        {"name": "persistent_greedy_decode", "route": "cuda",
         "source": "plankassembly_tpu_torch/csrc/decode.cu",
         "replaces": "plankassembly_tpu/ops/persistent_decode.py:632",
         "launches": launches["bf16"]["persistent_greedy_decode"],
         "max_abs_err": decode["err"], "ms": decode["ms"],
         "plain_ms": decode["plain_ms"], "bound_ms": decode["bound_ms"],
         "bound_by": decode["bound_by"], "library_ms": None},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
