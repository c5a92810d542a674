"""Build and binding of the port's hand-written CUDA kernels.

The sources are ``pbwt_tpu_torch/csrc/*.cu``, each with a plain C interface.
At first use they are compiled with ``nvcc`` for ``sm_90a``, one compiler
process for each source, all started together, linked into one shared
library under ``build/pbwt_tpu_torch/`` beside the package and loaded with
``ctypes``; nothing is compiled or loaded when the module is imported, so
the CPU tests import every module of the port without a toolchain.

Every pointer and the stream go to C as ``c_void_p`` (a bare Python int
would be cut to 32 bits). Each entry point returns ``cudaGetLastError()``
after its launches, and :func:`launch` raises when that is not 0: a refused
launch never runs, and a later ``torch.cuda.synchronize()`` would not say so.
:data:`LAUNCHES` counts, per kernel, the calls that launched it; each
launch is a span of the entry's name (:mod:`pbwt_tpu_torch.tracing`: a
``record_function`` while a profiler runs), so a trace (``-profile``) names
the hand-written kernels. The first load of the library is the span
``setup.kernels``, and ``kernels.builds`` counts the builds that ran nvcc.
:class:`Graph`
captures a function's launches once as a CUDA graph and replays it, each
replay counting the launches it holds.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

from .. import tracing

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pbwt_tpu_torch")
LIB_PATH = os.path.join(BUILD_DIR, "libpbwt_torch_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_L = ctypes.c_longlong
_SIGNATURES = {
    "k1_group_partition": [_I, _P, _L, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                           _I, _P],
    "k1_pack_columns": [_I, _P, _I, _I, _P, _I, _P],
    "k1_encode_columns": [_I, _P, _I, _I, _I, _P, _P, _P, _P],
    "k1_decode_columns": [_I, _P, _L, _I, _I, _I, _P, _P, _P, _P, _P],
    "k2_partition_ad_step": [_I, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P,
                             _P, _L, _P, _P, _P, _I, _I, _P],
    "k2_partition_ad_columns": [_I, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P,
                                _I, _I, _P],
    "k2_partition_ad_table": [_I, _P, _I, _P, _P, _I, _I, _I, _P, _I, _I,
                              _P],
    "k3_rank_plane": [_I, _P, _P, _I, _I, _P, _P],
    "k3_match_scan": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                      _P, _P, _I, _P, _P],
    "k4_ls_step": [_I, _P, _P, _P, _P, _I, _P, _I, _D, _D, _D, _D, _P],
    "k4_ls_eval": [_I, _P, _L, _I, _I, _I, _P, _I, _I, _D, _D, _D, _D, _D, _P,
                   _P, _P],
    "k5_impute_vote": [_I, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P, _P,
                       _P, _P, _P, _P, _P],
    "k6_paint_accumulate": [_I, _I, _I, _I, _P, _P, _L, _P, _P, _P, _P, _P,
                            _P, _P, _P, _P, _P, _P, _P, _P],
    "k7_fm_step": [_I, _P, _P, _P, _I, _P, _I, _I, _P, _I, _P, _P, _P, _P],
    "k8_sums": [_I, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "k8_chain": [_I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "k8_encode": [_I, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "k9_max_within": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                      _P, _P],
}

# entries that launch another entry's kernel, counted under its name
_KERNEL_OF = {"k2_partition_ad_columns": "k2_partition_ad_step",
              "k2_partition_ad_table": "k2_partition_ad_step"}

# kernel name -> number of wrapper calls that launched it
LAUNCHES = dict.fromkeys((k for k in _SIGNATURES if k not in _KERNEL_OF), 0)
# graph name -> number of replays (:class:`Graph`)
REPLAYS: dict[str, int] = {}

# entries that launch nothing: name -> argument types
_AUX_SIGNATURES = {"pbwt_partition_layout": [_I], "k3_plane_layout": [_I],
                   "k5_layout": [_I], "k8_layout": [_I]}

# scratch of the partition kernels (K1, K2): ints of the header, ints of one
# tile summary, and the fewest rows of a tile; checked against the compiled
# library when it loads
HEADER_INTS = 8
REC_INTS = 4
MIN_TILE = 512
ERROR_WORD = 2          # int of the header a capped wait reports through

# int32 words a block of K3's rank plane (the rank at the block's start, then
# the zero bits of its 32 * (PLANE_WORDS - 1) rows); checked likewise
PLANE_WORDS = 4

# K5's sites a chunk and most chunks a span of a block; checked likewise
K5_LAYOUT = (256, 32)

# K8's chain block: shared bytes before its prefix array, rows of its ring,
# most threads, positions a thread of the wide chain; checked likewise
K8_LAYOUT = (144, 2, 1024, 8)

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
    tracing.count("kernels.builds")
    cc, tag = nvcc(), f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    cmds = [[cc, *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    try:
        outs = [p.communicate()[0] for p in procs]
        failed = [(c, out) for c, p, out in zip(cmds, procs, outs)
                  if p.returncode != 0]
        tmp = f"{LIB_PATH}.{tag}"
        if not failed:
            link = [cc, "-shared", "-o", tmp, *objs]
            res = subprocess.run(link, capture_output=True, text=True)
            if res.returncode != 0:
                failed = [(link, res.stdout + res.stderr)]
        if failed:
            raise RuntimeError("pbwt_tpu_torch: kernel build failed:\n" +
                               "\n".join(" ".join(c) + "\n" + out
                                         for c, out in failed))
        os.replace(tmp, LIB_PATH)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            with tracing.span("setup.kernels"):
                _lib = _load()
    return _lib


def _load() -> ctypes.CDLL:
    """The library built if needed, loaded, its entries typed and its
    layouts checked."""
    lib = ctypes.CDLL(build())
    for name, argtypes in {**_SIGNATURES, **_AUX_SIGNATURES}.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    got = tuple(lib.pbwt_partition_layout(i) for i in (1, 2, 3))
    if got != (HEADER_INTS, REC_INTS, MIN_TILE):
        raise RuntimeError(f"pbwt_tpu_torch: partition scratch layout "
                           f"{got} != {(HEADER_INTS, REC_INTS, MIN_TILE)}")
    if lib.k3_plane_layout(1) != PLANE_WORDS:
        raise RuntimeError(f"pbwt_tpu_torch: rank plane of "
                           f"{lib.k3_plane_layout(1)} words a block, "
                           f"not {PLANE_WORDS}")
    if (lib.k5_layout(1), lib.k5_layout(2)) != K5_LAYOUT:
        raise RuntimeError(f"pbwt_tpu_torch: K5 layout "
                           f"{(lib.k5_layout(1), lib.k5_layout(2))}"
                           f" != {K5_LAYOUT}")
    got = tuple(lib.k8_layout(i) for i in (1, 2, 3, 4))
    if got != K8_LAYOUT:
        raise RuntimeError(f"pbwt_tpu_torch: K8 layout {got} != {K8_LAYOUT}")
    return lib


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(name: str, *args) -> None:
    """Call kernel entry ``name`` and count the launch; raises on a CUDA
    error code."""
    fn = getattr(library(), name)
    if len(args) != len(_SIGNATURES[name]):
        # ctypes would pass the surplus with its default conversion, an int
        raise TypeError(f"pbwt_tpu_torch: {name} takes "
                        f"{len(_SIGNATURES[name])} arguments, not {len(args)}")
    LAUNCHES[_KERNEL_OF.get(name, name)] += 1
    with tracing.span(name):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"pbwt_tpu_torch: {name} failed with cudaError_t "
                           f"{err}")


class Graph:
    """fn's kernel launches (and anything else it enqueues on the current
    stream, a captured NCCL collective included) captured once as a CUDA
    graph, to be replayed with no host work but the replay. Run fn once
    directly before (a warm-up: NCCL makes its communicator at its first
    collective, and nothing is allocated while capturing). The capture
    counts no launch; a replay is one span of ``name`` (:mod:`..tracing`)
    and adds to :data:`LAUNCHES` the launches fn made while captured. A
    capture that fails raises with torch's error."""

    def __init__(self, name: str, fn):
        self.name = name
        before = dict(LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        try:
            # thread-local: NCCL's watchdog thread may query its events
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                fn()
        finally:
            self.launches = {k: n - before[k] for k, n in LAUNCHES.items()
                             if n != before[k]}
            LAUNCHES.update(before)

    def replay(self) -> None:
        with tracing.span(self.name):
            self.graph.replay()
        REPLAYS[self.name] = REPLAYS.get(self.name, 0) + 1
        for k, n in self.launches.items():
            LAUNCHES[k] += n


def typed_cuda_tensors(*pairs: tuple[torch.Tensor, torch.dtype]
                       ) -> torch.device:
    """Check that each (tensor, dtype) pair is a contiguous CUDA tensor of
    that dtype, all on one device; returns that device."""
    dev = pairs[0][0].device
    for t, dtype in pairs:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError("pbwt_tpu_torch: kernel arguments must be "
                             "contiguous tensors on one CUDA device, wanted "
                             f"{dtype}, got {t.dtype} on {t.device}")
    if dev.type != "cuda":
        raise ValueError(f"pbwt_tpu_torch: no kernel for device {dev}")
    return dev


def cuda_tensors(*ts: torch.Tensor) -> torch.device:
    """Check that every tensor is a contiguous int32 CUDA tensor on one
    device; returns that device."""
    return typed_cuda_tensors(*((t, torch.int32) for t in ts))
