"""ctypes bindings to the native host runtime (csrc/pbwt_native.c).

Compiled on first use with the system C compiler into
``build/pbwt_tpu_torch/`` beside the package; every caller falls back to the
numpy implementations when the toolchain is unavailable, so the native layer
is a pure accelerator, never a correctness dependency. The fall is not
silent: the first ``get_lib()`` that returns None warns with the compiler's
output, which stays in ``build_log``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "pbwt_native.c")
_SO = os.path.join(os.path.dirname(_PKG), "build", "pbwt_tpu_torch",
                   "_pbwt_native.so")

_lib = None
_tried = False
build_log = ""      # why the library is missing, once get_lib() returned None


def compiler() -> str:
    """The C compiler the runtime is built with: $CC, else cc."""
    return os.environ.get("CC", "cc")


def _compile() -> bool:
    """Build _SO under a name of this process's own, then move it into
    place, so that processes racing on a first use each load a whole
    library."""
    global build_log
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [compiler(), "-O3", "-march=native", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        res = subprocess.run(cmd, capture_output=True, timeout=300)
        if res.returncode != 0:
            build_log = (" ".join(cmd) + "\n"
                         + (res.stdout + res.stderr).decode(errors="replace"))
            return False
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.TimeoutExpired) as e:
        build_log = f"{' '.join(cmd)}\n{e}"
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """Load (building if needed) the native library, or None; the first
    None comes with a warning that says why, since the numpy routes that
    take over are far slower."""
    global _warned
    lib = _load()
    if lib is None and build_log and not _warned:
        _warned = True
        warnings.warn("pbwt_tpu_torch: no host C runtime, the numpy routes "
                      f"take over: {build_log}", RuntimeWarning, stacklevel=2)
    return lib


_warned = False


def _load():
    global _lib, _tried, build_log
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or (os.path.exists(_SRC)
                    and os.path.getmtime(_SRC) > os.path.getmtime(_SO))):
            if not os.path.exists(_SRC):
                build_log = f"{_SRC} is missing"
                return None
            if not _compile():
                return None
        lib = ctypes.CDLL(_SO)
    except OSError as e:
        build_log = f"loading {_SO}: {e}"
        return None

    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    L = ctypes.c_long
    lib.p3_encode.restype = L
    lib.p3_encode.argtypes = [u8p, L, u8p]
    lib.p3_encode_cols.restype = L
    lib.p3_encode_cols.argtypes = [u8p, L, L, u8p, i64p]
    lib.p3_decode_cols.restype = L
    lib.p3_decode_cols.argtypes = [u8p, L, L, L, u8p]
    lib.fwd_a.restype = L
    lib.fwd_a.argtypes = [i32p, u8p, i32p, L]
    lib.build_pbwt.restype = L
    lib.build_pbwt.argtypes = [u8p, L, L, i32p, u8p, L]
    lib.sweep_match.restype = L
    lib.sweep_match.argtypes = [u8p, L, u8p, L, L, i32p, i32p, i64p, L]
    lib.sweep_match_packed.restype = L
    lib.sweep_match_packed.argtypes = [u8p, L, L, u8p, L, L, L, i32p, i32p,
                                       i64p, L]
    lib.select_repack.restype = L
    lib.select_repack.argtypes = [u8p, L, L, L, u8p, i32p, u8p, L, i32p]
    lib.col_counts.restype = L
    lib.col_counts.argtypes = [u8p, L, L, L, i64p]
    lib.format_match_rows.restype = L
    lib.format_match_rows.argtypes = [i64p, L, u8p, L]
    lib.sweep_match_print.restype = L
    lib.sweep_match_print.argtypes = [u8p, L, L, u8p, L, L, L, i32p, i32p,
                                      ctypes.c_int, i64p]
    lib.subsample_repack.restype = L
    lib.subsample_repack.argtypes = [u8p, L, L, L, i64p, L, i32p, u8p, L,
                                     i32p]
    lib.transpose_u8.restype = None
    lib.transpose_u8.argtypes = [u8p, L, L, u8p]
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.vcf_parse_gt.restype = L
    lib.vcf_parse_gt.argtypes = [ctypes.c_char_p, L, L, L, i8p]
    lib.natural_cols.restype = L
    lib.natural_cols.argtypes = [u8p, L, L, L, i32p, u8p, i64p]
    lib.build_reverse_core.restype = L
    lib.build_reverse_core.argtypes = [u8p, L, L, L, i32p, u8p, L, i32p]
    _lib = lib
    return _lib


# --------------------------------------------------------------------------
# high-level wrappers (None return = use the numpy fallback)
# --------------------------------------------------------------------------

_transpose_pool: dict[tuple, np.ndarray] = {}
_buffer_pool: dict[str, np.ndarray] = {}


def pooled(nbytes: int, tag: str) -> np.ndarray:
    """Process-lifetime scratch buffer of >= nbytes uint8, keyed by tag.

    Some containers fault fresh pages in an order of magnitude slower
    than the compute that fills them; reusing one buffer
    per call-site keeps large temporaries warm. Callers must not hold the
    result across calls with the same tag."""
    buf = _buffer_pool.get(tag)
    if buf is None or buf.nbytes < nbytes:
        buf = np.empty(nbytes, np.uint8)
        buf.fill(0)                      # fault pages in once
        _buffer_pool[tag] = buf
    return buf


def pooled_view(shape, dtype, tag: str) -> np.ndarray:
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return pooled(n, tag)[:n].view(dtype).reshape(shape)


def transpose_u8(X: np.ndarray):
    """Cache-blocked (R, C) -> (C, R) uint8 transpose, or None.

    The output buffer is pooled per shape: fresh multi-MB allocations can
    fault in an order of magnitude slower than the transpose itself.  Callers must treat the result as scratch
    (engine.build_from_haplotypes consumes and discards it)."""
    lib = get_lib()
    if lib is None:
        return None
    X = np.ascontiguousarray(X, np.uint8)
    R, C = X.shape
    out = _transpose_pool.get((C, R))
    if out is None:
        out = np.empty((C, R), np.uint8)
        _transpose_pool.clear()
        _transpose_pool[(C, R)] = out
    lib.transpose_u8(X, R, C, out)
    return out


def build_pbwt(cols: np.ndarray, a0: np.ndarray):
    """cols (N, M) site-major natural-order -> (yz bytes, aFend) or None."""
    lib = get_lib()
    if lib is None:
        return None
    N, M = cols.shape
    cols = np.ascontiguousarray(cols, np.uint8)
    a = np.ascontiguousarray(a0, np.int32).copy()
    cap = max(1024, N * (M // 32 + 8))
    while True:
        yz = np.empty(cap, np.uint8)
        a_try = a.copy()
        n = lib.build_pbwt(cols, M, N, a_try, yz, cap)
        if n <= cap:
            return yz[:n].tobytes(), a_try
        cap = n


def build_pbwt_chunk(cols: np.ndarray, a: np.ndarray):
    """Advance ``a`` IN PLACE through ``cols`` ((ncols, M) natural-order
    values), returning the pack3 bytes for those columns, or None when the
    native library is unavailable.

    This is the streaming-cursor fast path (engine.WriteCursor buffers
    natural-order columns and flushes them here): one C call per ~8 MB of
    buffered columns replaces the per-site python permute + pack3 +
    partition that mirrors pbwtCursorWriteForwards (pbwtCore.c:573-585).
    ``a`` must be int32 and C-contiguous."""
    lib = get_lib()
    if lib is None:
        return None
    ncols, M = cols.shape
    cols = np.ascontiguousarray(cols, np.uint8)
    # pack3 never emits more than one byte per encoded symbol, so
    # ncols * (M + 8) bounds the output (run buffer sizing in the C side)
    cap = ncols * (M + 8) + 16
    yz = pooled(cap, "build_chunk")
    n = lib.build_pbwt(cols, M, ncols, a, yz, cap)
    if n > cap:
        raise AssertionError("pack3 chunk overflowed its worst-case bound")
    return yz[:n].tobytes()


def pack_advance(y: np.ndarray, a: np.ndarray):
    """One write-cursor step (pbwtCursorWriteForwards, pbwtCore.c:573-578):
    pack3-encode the sorted column and advance ``a`` IN PLACE.  Returns the
    packed bytes, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    y = np.ascontiguousarray(y, np.uint8)
    M = y.shape[0]
    out = pooled(M + 8, "pack_adv_out")
    nb = lib.p3_encode(y, M, out)
    ones = pooled_view(M, np.int32, "pack_adv_ones")
    lib.fwd_a(a, y, ones, M)
    return out[:nb].tobytes()


def natural_cols(yz: bytes, ncols: int, M: int, a0: np.ndarray,
                 start: int = 0, with_pos: bool = False):
    """Stream a packed PBWT into site-major NATURAL-order columns.

    Returns (X (ncols, M) uint8, a_end, ones_per_col int64) or None — or,
    with ``with_pos``, (X, a_end, counts, next_start) so a caller can
    stream the panel in site chunks with O(M * chunk) live bytes (pass the
    advanced ``a_end`` back as ``a0`` and ``next_start`` as ``start``).
    One C pass (decode + scatter + prefix advance) replaces
    decode-everything + a python a-chase + a transpose."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(yz), np.uint8)[start:]
    a = np.ascontiguousarray(a0, np.int32).copy()
    X = np.empty((ncols, M), np.uint8)
    counts = np.empty(ncols, np.int64)
    used = lib.natural_cols(buf, len(buf), ncols, M, a, X.reshape(-1), counts)
    if used < 0:
        raise ValueError("corrupt pack3 stream")
    if with_pos:
        return X, a, counts, start + int(used)
    return X, a, counts


def build_reverse_core(yz: bytes, M: int, N: int, aFend: np.ndarray):
    """pbwtBuildReverse as one C pass (offsets skim + backward stream +
    fused gather/encode/partition emit).  Returns (zz bytes, aRend) or
    None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(yz), np.uint8)
    a_end = np.ascontiguousarray(aFend, np.int32)
    cap = len(buf) + 16 * N + 65536
    while True:
        zz = np.empty(cap, np.uint8)
        arend = a_end.copy()
        n = lib.build_reverse_core(buf, len(buf), M, N, a_end, zz, cap,
                                   arend)
        if n < 0:
            raise ValueError("build_reverse_core: corrupt pack3 stream")
        if n <= cap:
            return zz[:n].tobytes(), arend
        cap = int(n)


def decode_cols(yz: bytes, ncols: int, M: int):
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(bytes(yz), np.uint8)
    # decoded() caches the result on the PBWT, so this buffer must be owned
    # by the caller: pool only the page-fault cost via a warm template when
    # the same shape repeats (pooled buffers themselves can't be handed out)
    Y = np.empty((ncols, M), np.uint8)
    used = lib.p3_decode_cols(buf, len(buf), ncols, M, Y.reshape(-1))
    if used < 0:
        raise ValueError("corrupt pack3 stream")
    return Y


def encode_cols(Y: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    Y = np.ascontiguousarray(Y, np.uint8)
    ncols, M = Y.shape
    out = np.empty(ncols * (M + 8) + 16, np.uint8)
    offsets = np.empty(ncols + 1, np.int64)
    n = lib.p3_encode_cols(Y.reshape(-1), ncols, M, out, offsets)
    return out[:n].tobytes(), offsets


def sweep_match_packed(yzp: bytes, M: int, yzq: bytes, Q: int, N: int,
                       ap0: np.ndarray, aq0: np.ndarray):
    """Dynamic sweep matcher streaming both pack3 streams; rows or None."""
    lib = get_lib()
    if lib is None:
        return None
    zp = np.frombuffer(yzp, np.uint8)
    zq = np.frombuffer(yzq, np.uint8)
    ap0 = np.ascontiguousarray(ap0, np.int32)
    aq0 = np.ascontiguousarray(aq0, np.int32)
    cap = max(4096, 8 * Q + N)
    while True:
        out = pooled_view((cap, 4), np.int64, "rows:sweep")
        n = lib.sweep_match_packed(zp, len(zp), M, zq, len(zq), Q, N,
                                   ap0, aq0, out.reshape(-1), cap)
        if n < 0:
            return None
        if n <= cap:
            return out[:n]
        cap = n


def select_repack(yz: bytes, M: int, N: int, keep: np.ndarray,
                  a0: np.ndarray):
    """Stream-select sites keep[k] != 0 and re-PBWT; (yz', a_end) or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    keep = np.ascontiguousarray(keep, np.uint8)
    a0 = np.ascontiguousarray(a0, np.int32)
    a_end = np.empty(M, np.int32)
    cap = max(len(z) + 16, 4096)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.select_repack(z, len(z), M, N, keep, a0, out, cap, a_end)
        if n < 0:
            return None
        if n <= cap:
            return out[:n].tobytes(), a_end
        cap = n


def _stdout_fd(stream) -> int:
    """File descriptor of a real stdout, or -1 when redirected in-process."""
    try:
        return stream.fileno()
    except (OSError, AttributeError, ValueError):
        return -1


def sweep_match_print(yzp: bytes, M: int, yzq: bytes, Q: int, N: int,
                      ap0: np.ndarray, aq0: np.ndarray, fd: int):
    """Stream sweep MATCH lines to fd; returns (n_reports, tot_len,
    n_nonzero) or None."""
    lib = get_lib()
    if lib is None:
        return None
    zp = np.frombuffer(yzp, np.uint8)
    zq = np.frombuffer(yzq, np.uint8)
    stats = np.zeros(3, np.int64)
    n = lib.sweep_match_print(zp, len(zp), M, zq, len(zq), Q, N,
                              np.ascontiguousarray(ap0, np.int32),
                              np.ascontiguousarray(aq0, np.int32), fd, stats)
    if n < 0:
        return None
    return int(stats[0]), int(stats[1]), int(stats[2])


def write_match_rows(rows: np.ndarray, out) -> bool:
    """Bulk-format (n, 4) match rows as MATCH lines into the binary stream
    ``out`` (chunked); returns False when the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, np.int64)
    CHUNK = 1 << 21
    for i0 in range(0, len(rows), CHUNK):
        part = rows[i0:i0 + CHUNK]
        cap = 144 * len(part)
        buf = pooled_view((cap,), np.uint8, "rows:fmt")
        n = lib.format_match_rows(part.reshape(-1), len(part), buf, cap)
        out.write(buf[:n].tobytes())
    return True


def col_counts(yz: bytes, M: int, N: int):
    """Per-site zero counts straight off the run-length bytes, or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    c0 = np.empty(N, np.int64)
    if lib.col_counts(z, len(z), M, N, c0) < 0:
        return None
    return c0


def subsample_repack(yz: bytes, M: int, N: int, select: np.ndarray,
                     a0: np.ndarray):
    """Stream-re-PBWT a haplotype selection; (yz', a_end) or None."""
    lib = get_lib()
    if lib is None:
        return None
    z = np.frombuffer(yz, np.uint8)
    select = np.ascontiguousarray(select, np.int64)
    a0 = np.ascontiguousarray(a0, np.int32)
    Mnew = len(select)
    a_end = np.empty(Mnew, np.int32)
    cap = max(len(z) + 16, 4096)
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.subsample_repack(z, len(z), M, N, select, Mnew, a0, out,
                                 cap, a_end)
        if n < 0:
            return None
        if n <= cap:
            return out[:n].tobytes(), a_end
        cap = n


def sweep_match(Ysp: np.ndarray, ap0: np.ndarray, Ysq: np.ndarray,
                aq0: np.ndarray):
    """Dynamic sweep query-vs-panel match reports (n, 4) int64, or None."""
    lib = get_lib()
    if lib is None:
        return None
    N, M = Ysp.shape
    Nq, Q = Ysq.shape
    assert N == Nq
    cap = max(4096, 8 * Q + N)
    while True:
        out = np.empty((cap, 4), np.int64)
        n = lib.sweep_match(np.ascontiguousarray(Ysp, np.uint8).reshape(-1), M,
                            np.ascontiguousarray(Ysq, np.uint8).reshape(-1), Q,
                            N, np.ascontiguousarray(ap0, np.int32),
                            np.ascontiguousarray(aq0, np.int32),
                            out.reshape(-1), cap)
        if n <= cap:
            return out[:n]
        cap = n
