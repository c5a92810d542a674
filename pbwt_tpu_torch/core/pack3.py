"""pack3: the 3-tier run-length byte code used by .pbwt files.

Byte layout (reference pbwtCore.c:216-231):
  bit 7          = symbol (0/1)
  bits 6..0      = run length code:
      0..63      -> n = code            (1-byte runs up to 63)
      64..95     -> n = (code-64) << 6  (runs up to 31<<6  = 1984, step 64)
      96..127    -> n = (code-96) << 11 (runs up to 31<<11 = 63488, step 2048)

The greedy encoder (pack3Add, pbwtCore.c:240-252) emits, per run of length n:
  while n >= 63488: byte sym|0x7f ; n -= 63488
  if    n >= 2048 : byte sym|0x60|(n>>11) ; n &= 0x7ff
  if    n >= 64   : byte sym|0x40|(n>>6)  ; n &= 0x3f
  if    n         : byte sym|n

Byte-for-byte parity with the reference encoder is required because .pbwt
files are compared bit-identically by the test suite.  All functions here
are vectorised numpy; a C fast path may override them (pbwt_tpu_torch.core.native).
"""

from __future__ import annotations

import numpy as np

ENCODE_MAX1 = 64
ENCODE_MAX2 = 32 << 6  # 2048
ENCODE_MAX3 = 31 << 11  # 63488

# decode LUT for the low 7 bits (pack3init, pbwtCore.c:232-238)
P3DECODE = np.zeros(128, dtype=np.int64)
P3DECODE[0:64] = np.arange(64)
P3DECODE[64:96] = (np.arange(64, 96) - 64) << 6
P3DECODE[96:128] = (np.arange(96, 128) - 96) << 11

Y_SENTINEL = 2  # pbwt.h:143 - value that can never equal a real allele


def _runs(y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run-length encode a column: returns (symbols, lengths)."""
    y = np.ascontiguousarray(y, dtype=np.uint8)
    if y.size == 0:
        return np.zeros(0, np.uint8), np.zeros(0, np.int64)
    change = np.flatnonzero(y[1:] != y[:-1])
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [y.size]))
    return y[starts], (ends - starts).astype(np.int64)


def encode_runs(syms: np.ndarray, lens: np.ndarray) -> bytes:
    """Greedy pack3 emission for a sequence of runs (vectorised)."""
    syms = syms.astype(np.uint32)
    lens = lens.astype(np.int64)
    top = (syms << 7).astype(np.uint32)

    n3 = lens // ENCODE_MAX3
    r = lens - n3 * ENCODE_MAX3
    has2 = r >= ENCODE_MAX2
    r2code = np.where(has2, r >> 11, 0)
    r = np.where(has2, r & 0x7FF, r)
    has1 = r >= ENCODE_MAX1
    r1code = np.where(has1, r >> 6, 0)
    r = np.where(has1, r & 0x3F, r)
    has0 = r > 0

    counts = n3 + has2 + has1 + has0
    offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    out = np.empty(offsets[-1], dtype=np.uint8)

    # 3-byte-tier repeats (rare: only when a run >= 63488)
    tot3 = int(n3.sum())
    if tot3:
        rep = np.repeat(np.arange(len(n3)), n3)
        base = np.repeat(offsets[:-1], n3)
        cum3 = np.concatenate(([0], np.cumsum(n3)[:-1]))
        within = np.arange(tot3) - np.repeat(cum3, n3)
        out[base + within] = (top[rep] | 0x7F).astype(np.uint8)

    pos = offsets[:-1] + n3
    if has2.any():
        idx = np.flatnonzero(has2)
        out[pos[idx]] = (top[idx] | 0x60 | r2code[idx]).astype(np.uint8)
    pos = pos + has2
    if has1.any():
        idx = np.flatnonzero(has1)
        out[pos[idx]] = (top[idx] | 0x40 | r1code[idx]).astype(np.uint8)
    pos = pos + has1
    if has0.any():
        idx = np.flatnonzero(has0)
        out[pos[idx]] = (top[idx] | r[idx]).astype(np.uint8)

    return out.tobytes()


def pack3(y: np.ndarray) -> bytes:
    """Pack one column of M 0/1 values; mirrors pack3 (pbwtCore.c:254-267)."""
    syms, lens = _runs(y)
    return encode_runs(syms, lens)


def decode_lengths(yz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decode a raw pack3 byte buffer into (symbols, run lengths)."""
    yz = np.frombuffer(yz, dtype=np.uint8) if isinstance(yz, (bytes, bytearray)) else yz
    return (yz >> 7).astype(np.uint8), P3DECODE[yz & 0x7F]


def unpack_all(yz, M: int, N: int | None = None):
    """Decode a multi-column pack3 buffer.

    Returns ``(Y, col_byte_offsets)`` where Y is a uint8 array of shape
    (ncols, M) holding the stored values in sorted order per column, and
    col_byte_offsets[i] is the byte offset of column i in yz
    (len ncols+1).  Columns are validated to align exactly at multiples
    of M, as guaranteed by the encoder (unpack3, pbwtCore.c:279-305).
    """
    buf = np.frombuffer(bytes(yz), dtype=np.uint8)
    syms, lens = decode_lengths(buf)
    cum = np.cumsum(lens)
    total = int(cum[-1]) if cum.size else 0
    if total % M:
        raise ValueError(f"pack3 stream of {total} values is not a multiple of M={M}")
    ncols = total // M
    if N is not None and ncols != N:
        raise ValueError(f"pack3 stream has {ncols} columns, expected {N}")
    # column boundaries: cumulative length must hit every multiple of M exactly
    ends = np.searchsorted(cum, np.arange(1, ncols + 1) * M)
    if ncols and not (cum[ends] == np.arange(1, ncols + 1) * M).all():
        raise ValueError("pack3 runs cross column boundaries - corrupt stream")
    col_offsets = np.concatenate(([0], ends + 1)).astype(np.int64)
    flat = np.repeat(syms, lens)
    return flat.reshape(ncols, M), col_offsets


def extend_match_forwards(yzp, M: int, x: int, f: int, g: int,
                          off: int = 0) -> tuple[int, int, int]:
    """FM-style extension of a match interval [f, g) one column forward on
    the packed stream (extendMatchForwards, pbwtCore.c:320-357).

    Returns (f', g', bytes_consumed)."""
    m = 0
    nc = [0, 0]
    pos = off
    z = 0
    # advance to the block containing f
    while m <= f:
        b = yzp[pos]
        pos += 1
        n = int(P3DECODE[b & 0x7F])
        m += n
        z = b >> 7
        nc[z] += n
    f = f + nc[z] - m if z == x else nc[z]
    if g < M:
        while m <= g:
            b = yzp[pos]
            pos += 1
            n = int(P3DECODE[b & 0x7F])
            m += n
            z = b >> 7
            nc[z] += n
        g = g + nc[z] - m if z == x else nc[z]
    while m < M:
        b = yzp[pos]
        pos += 1
        n = int(P3DECODE[b & 0x7F])
        m += n
        nc[b >> 7] += n
    if g == M:
        g = (M - nc[0]) if x else nc[0]
    if x:
        f += nc[0]
        g += nc[0]
    return f, g, pos - off


def extend_packed_forwards(yzp, M: int, f: int, off: int = 0
                           ) -> tuple[int, int, int]:
    """Move a single pointer f one column forward on the packed stream
    (extendPackedForwards, pbwtCore.c:360-373).

    Returns (f', value_at_f, bytes_consumed)."""
    m = 0
    nc = [0, 0]
    pos = off
    z = 0
    while m <= f:
        b = yzp[pos]
        pos += 1
        n = int(P3DECODE[b & 0x7F])
        m += n
        z = b >> 7
        nc[z] += n
    f = f + nc[z] - m
    val = z
    while m < M:
        b = yzp[pos]
        pos += 1
        n = int(P3DECODE[b & 0x7F])
        m += n
        nc[b >> 7] += n
    if val:
        f += nc[0]
    return f, val, pos - off


def extend_packed_backwards(yzp, M: int, f: int, c: int, off: int
                            ) -> tuple[int, int, int]:
    """Move a single pointer f one column backward on the packed stream
    (extendPackedBackwards, pbwtCore.c:375-397).  ``off`` is the byte
    offset of the NEXT column; ``c`` is the zero-count of the previous one.

    Returns (f', value, start_offset_of_previous_column)."""
    pos = off
    m = 0
    while m < M:
        pos -= 1
        m += int(P3DECODE[yzp[pos] & 0x7F])
    start = pos
    m = 0
    nc = [0, 0]
    if f < c:                       # it was a 0
        while nc[0] <= f:
            b = yzp[pos]
            pos += 1
            n = int(P3DECODE[b & 0x7F])
            m += n
            nc[b >> 7] += n
        return f + nc[1], 0, start
    else:                           # it was a 1
        while nc[1] <= f - c:
            b = yzp[pos]
            pos += 1
            n = int(P3DECODE[b & 0x7F])
            m += n
            nc[b >> 7] += n
        return f + nc[0] - c, 1, start


def pack_columns(Y: np.ndarray) -> tuple[bytes, np.ndarray]:
    """Pack many columns; returns (bytes, per-column byte offsets len ncols+1).

    Vectorised across the whole matrix: computes runs for every column in one
    pass by inserting artificial breaks at column boundaries.
    """
    Y = np.ascontiguousarray(Y, dtype=np.uint8)
    ncols, M = Y.shape
    if ncols == 0:
        return b"", np.zeros(1, np.int64)
    flat = Y.reshape(-1)
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    bounds = np.arange(1, ncols) * M
    starts = np.unique(np.concatenate(([0], change, bounds)))
    ends = np.concatenate((starts[1:], [flat.size]))
    syms = flat[starts]
    lens = (ends - starts).astype(np.int64)
    data = encode_runs(syms, lens)
    # byte offsets per column: count bytes contributed by runs in each column
    n3 = lens // ENCODE_MAX3
    r = lens - n3 * ENCODE_MAX3
    nbytes = n3 + (r >= ENCODE_MAX2) + ((r & 0x7FF) >= ENCODE_MAX1) + ((r & 0x3F) > 0)
    # careful: the has1 test applies to r after has2 masking, has0 after has1
    r_after2 = np.where(r >= ENCODE_MAX2, r & 0x7FF, r)
    r_after1 = np.where(r_after2 >= ENCODE_MAX1, r_after2 & 0x3F, r_after2)
    nbytes = n3 + (r >= ENCODE_MAX2) + (r_after2 >= ENCODE_MAX1) + (r_after1 > 0)
    col_of_run = starts // M
    col_bytes = np.zeros(ncols, np.int64)
    np.add.at(col_bytes, col_of_run, nbytes)
    offsets = np.concatenate(([0], np.cumsum(col_bytes)))
    return data, offsets
