"""Build and binding of the port's hand-written CUDA kernels.

The sources are ``pbwt_tpu_torch/csrc/*.cu``, each with a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a`` into one shared
library under ``build/pbwt_tpu_torch/`` beside the package and loaded with
``ctypes``; nothing is compiled or loaded when the module is imported, so
the CPU tests import every module of the port without a toolchain.

Every pointer and the stream go to C as ``c_void_p`` (a bare Python int
would be cut to 32 bits). Each entry point returns ``cudaGetLastError()``
after its launches, and :func:`launch` raises when that is not 0: a refused
launch never runs, and a later ``torch.cuda.synchronize()`` would not say so.
:data:`LAUNCHES` counts, per kernel, the calls that launched it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pbwt_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libpbwt_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "k1_group_partition": [_I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                           _P],
    "k2_partition_ad_step": [_I, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                             _P, _P, _P],
    "k3_match_scan": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                      _P, _I, _P, _P],
}

# kernel name -> number of wrapper calls that launched it
LAUNCHES = dict.fromkeys(_SIGNATURES, 0)

# rows per block of K1 and K2, and ints per block summary; checked against the
# compiled library when it loads
K1_BLOCK = 1024
K2_BLOCK = 2048
SUM_INTS = 5

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, then PATH, then
    /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("pbwt_tpu_torch: nvcc not found (set CUDA_HOME)")


def sources() -> list[str]:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith(".cu"))


def build(force: bool = False) -> str:
    """Compile the kernels into LIB_PATH unless it is newer than every
    source; returns the library path. Raises with nvcc's output on failure."""
    srcs = sources()
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= max(map(os.path.getmtime,
                                                      srcs))):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("pbwt_tpu_torch: kernel build failed:\n"
                           + " ".join(cmd) + "\n" + res.stdout + res.stderr)
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pbwt_tile.argtypes = [ctypes.c_int]
            lib.pbwt_tile.restype = ctypes.c_int
            got = (lib.pbwt_tile(1), lib.pbwt_tile(2), lib.pbwt_tile(3))
            if got != (K1_BLOCK, K2_BLOCK, SUM_INTS):
                raise RuntimeError(f"pbwt_tpu_torch: kernel tiles {got} != "
                                   f"{(K1_BLOCK, K2_BLOCK, SUM_INTS)}")
            _lib = lib
    return _lib


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, *args) -> None:
    """Call kernel entry ``name`` and count the launch; raises on a CUDA
    error code."""
    fn = getattr(library(), name)
    LAUNCHES[name] += 1
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"pbwt_tpu_torch: {name} failed with cudaError_t "
                           f"{err}")


def cuda_tensors(*ts: torch.Tensor) -> torch.device:
    """Check that every tensor is a contiguous int32 CUDA tensor on one
    device; returns that device."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("pbwt_tpu_torch: kernel arguments must be "
                             "contiguous int32 tensors on one CUDA device, "
                             f"got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"pbwt_tpu_torch: no kernel for device {dev}")
    return dev
