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
files are compared bit-identically by the test suite.  This module holds
the one-column encoder in vectorised numpy; whole panels are encoded and
decoded by the host C runtime (pbwt_tpu_torch.core.native: encode_cols,
decode_cols, natural_cols).
"""

from __future__ import annotations

import numpy as np

ENCODE_MAX1 = 64
ENCODE_MAX2 = 32 << 6  # 2048
ENCODE_MAX3 = 31 << 11  # 63488


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
