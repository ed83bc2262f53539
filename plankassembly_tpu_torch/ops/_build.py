"""Build and load the port's CUDA kernels.

Each source in `plankassembly_tpu_torch/csrc/*.cu` compiles with its own
`nvcc -c`, all started at once, and one more `nvcc` call links the objects
into one shared library with a plain C interface, loaded with `ctypes`.
No source includes PyTorch's headers, so the build takes seconds, not the
minutes a `torch.utils.cpp_extension` build takes. The library goes
to `build/torch_kernels/<hash>/` at the repository root, keyed by a hash of
the sources and flags, at first use; nothing is compiled when a module is
imported.

Every launch function takes raw pointers, sizes and a `cudaStream_t`, and
returns the `cudaError_t` of `cudaGetLastError()` after its launches.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]  # -v: registers and spills, in build_log
LIB_NAME = "libplank_kernels.so"

P = ctypes.c_void_p
I64 = ctypes.c_longlong
F32 = ctypes.c_float
I32 = ctypes.c_int
U32 = ctypes.c_uint

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None
build_log = ""


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the GPU")
    return path


def build() -> str:
    """Compile the kernels if this exact source set has not been built;
    return the library's path."""
    global build_seconds, build_log
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    out_dir = os.path.join(BUILD_ROOT, h.hexdigest()[:16])
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [s for s in sources() if s.endswith(".cu")]
    objs = [os.path.join(out_dir, os.path.basename(c) + f".{os.getpid()}.o")
            for c in cus]
    t0 = time.perf_counter()
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, c],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), c)
             for c, o in zip(cus, objs)]
    logs = []
    for proc, c in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            for other, _ in procs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {c}:\n"
                               f"{out}")
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(link)}\n{proc.stdout}\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs) + proc.stdout + proc.stderr
    for o in objs:
        os.remove(o)
    os.replace(tmp, lib_path)
    return lib_path


def _declare(lib):
    lib.plank_flash_attention.argtypes = [
        P, P, P, P, P,                 # q, k, v, kv_lengths, out
        I64, I64, I64, I64, I64, I64,  # B, H, Hkv, Lq, Lk, Dh
        F32, I32, I32, P]              # sm_scale, causal, is_bf16, stream
    lib.plank_flash_attention.restype = I32
    lib.plank_decode_run.argtypes = [P, I64, P, P]  # args struct, steps a
    lib.plank_decode_run.restype = I32             # graph, stream, stats
    lib.plank_flash_train_fwd.argtypes = [
        P, P, P, P, P, P, P,                # q, k, v, kv_len, seed, out,
                                            # stats
        I64, I64, I64, I64, I64, I64, I64,  # B, H, Hkv, Lq, Lk, Dh, Lk_pad
        F32, I32, I32, U32, F32, I64,       # sm_scale, causal, dropout,
                                            # threshold, 1 - rate, plan block
        I32, P]                             # is_bf16, stream
    lib.plank_flash_train_fwd.restype = I32
    lib.plank_flash_train_bwd.argtypes = [
        P, P, P, P, P, P, P, P,             # q, k, v, dout, kv_len, seed,
                                            # stats, dbuf
        P, P, P,                            # dq, dk, dv
        I64, I64, I64, I64, I64, I64,       # B, H, Hkv, Lq, Lk, Dh
        F32, I32, I32, U32, F32, I64,       # sm_scale, causal, dropout,
                                            # threshold, 1 - rate, plan block
        I32, P]                             # is_bf16, stream
    lib.plank_flash_train_bwd.restype = I32
    lib.plank_cross_attn_decode.argtypes = [
        P, P, P, P, P, P, P,           # q, k, v, bias, k_scale, v_scale, out
        I64, I64, I64, F32, I32, I32,  # BH, Li, Dh, sm_scale, q bf16, kv int8
        P]                             # stream
    lib.plank_cross_attn_decode.restype = I32
    lib.plank_fused_layer.argtypes = (
        [P] * 10      # x, wqkv, bqkv, wos, bos, wqc, bqc, woc, boc, ln
        + [P] * 9     # k/v caches, their scales, ck, cv, cks, cvs, cbias
        + [P] * 5     # x_out, nk, nv, nks, nvs
        + [P] * 3     # qkv, h, x_mid
        + [I64] * 7   # B, H, Dh, S, Li, CH, t
        + [F32, I32, P])  # sm_scale, is_bf16, stream
    lib.plank_fused_layer.restype = I32
    lib.plank_fused_ffn.argtypes = (
        [P] * 6       # x, w1, b1, w2, b2, ln3
        + [P] * 2     # h, out
        + [I64] * 3   # B, D, F
        + [I32, P])   # is_bf16, stream
    lib.plank_fused_ffn.restype = I32


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
    return _lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")
