"""Build and load the port's CUDA kernels.

All sources in `plankassembly_tpu_torch/csrc/*.cu` compile with one `nvcc`
call into one shared library with a plain C interface, loaded with
`ctypes`. No source includes PyTorch's headers, so the build takes seconds,
not the minutes a `torch.utils.cpp_extension` build takes. The library goes
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
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]  # -v: registers and spills, in build_log
LIB_NAME = "libplank_kernels.so"

P = ctypes.c_void_p
I64 = ctypes.c_longlong
F32 = ctypes.c_float
I32 = ctypes.c_int

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
    cus = [s for s in sources() if s.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    os.replace(tmp, lib_path)
    return lib_path


def _declare(lib):
    lib.plank_flash_attention.argtypes = [
        P, P, P, P, P,                 # q, k, v, kv_lengths, out
        I64, I64, I64, I64, I64, I64,  # B, H, Hkv, Lq, Lk, Dh
        F32, I32, I32, P]              # sm_scale, causal, is_bf16, stream
    lib.plank_flash_attention.restype = I32
    lib.plank_decode_step.argtypes = [P, I64, P]  # args struct, t, stream
    lib.plank_decode_step.restype = I32
    lib.plank_decode_setup.argtypes = [P]
    lib.plank_decode_setup.restype = I32


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
