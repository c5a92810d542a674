"""Plain reference of PBWT construction and its pack3 byte stream.

Construction (Durbin 2014, Algorithm 1): the prefix array starts as
0 .. M-1; at each site the column of alleles is read in the current order
(the sorted column the .pbwt file stores), and the order is split stably
into the haplotypes carrying 0 and then those carrying 1.

pack3 (pbwtCore.c, ``pack3Add``): each sorted column is cut into runs of
one allele, and a run of n is written greedily as bytes whose bit 7 is the
allele: 0x7f (31 << 11 = 63,488) while n >= 63,488; then 0x60 | n >> 11 and
n &= 0x7ff if n >= 2,048; then 0x40 | n >> 6 and n &= 0x3f if n >= 64; then
n itself if it is not 0. Columns are encoded one after another.

Plain torch on any device; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK_SITES = 1024      # sorted columns encoded at a time
MAX3, MAX2, MAX1 = 31 << 11, 2048, 64


def pack3_columns(Y: torch.Tensor, one_tier: bool = False) -> bytes:
    """pack3 bytes of the (c, M) uint8 sorted columns Y, column after
    column. one_tier writes every run in bytes of at most 63 (the control:
    a run-length code that decodes alike but is not the .pbwt format's)."""
    c, M = Y.shape
    if c == 0:
        return b""
    dev = Y.device
    start = torch.ones((c, M), dtype=torch.bool, device=dev)
    start[:, 1:] = Y[:, 1:] != Y[:, :-1]
    first = torch.nonzero(start.view(-1)).squeeze(1)
    length = torch.diff(first, append=torch.tensor([c * M], device=dev))
    top = Y.view(-1)[first].long() << 7
    if one_tier:
        full, rest = length // 63, length % 63
        tiers = [(full, top | 63), (rest > 0, top | rest)]
    else:
        n3, r = length // MAX3, length % MAX3
        has2 = r >= MAX2
        b2 = top | 0x60 | (r >> 11)
        r = torch.where(has2, r & 0x7FF, r)
        has1 = r >= MAX1
        b1 = top | 0x40 | (r >> 6)
        r = torch.where(has1, r & 0x3F, r)
        tiers = [(n3, top | 0x7F), (has2, b2), (has1, b1), (r > 0, top | r)]
    counts = [t[0].long() for t in tiers]
    size = torch.stack(counts).sum(0)
    offset = torch.cumsum(size, 0) - size
    out = torch.empty(int(size.sum()), dtype=torch.uint8, device=dev)
    for n, byte in tiers:
        n = n.long()
        run = torch.repeat_interleave(torch.arange(len(n), device=dev), n)
        within = torch.arange(len(run), device=dev) - (torch.cumsum(n, 0) - n)[run]
        out[offset[run] + within] = byte[run].to(torch.uint8)
        offset = offset + n
    return out.cpu().numpy().tobytes()


def build(cols: torch.Tensor, boundaries=(), one_tier: bool = False):
    """Construction from the (N, M) uint8 natural-order site columns.

    Returns (yz bytes, aFend int64[M], marks): marks[k] = (byte offset of
    site k's column, prefix array before site k) for each k in boundaries
    (k = N: the end).
    """
    N, M = cols.shape
    dev = cols.device
    a = torch.arange(M, device=dev)
    want = {int(k) for k in boundaries}
    cuts = sorted(want | set(range(0, N, CHUNK_SITES)) | {N})
    parts, marks, size = [], {}, 0
    for lo, hi in zip(cuts, cuts[1:] + [None]):
        if lo in want:
            marks[lo] = (size, a.cpu().numpy())
        if hi is None or lo >= N:
            break
        Y = torch.empty((hi - lo, M), dtype=torch.uint8, device=dev)
        for k in range(lo, hi):
            y = cols[k][a]
            Y[k - lo] = y
            a = a[torch.argsort(y, stable=True)]
        parts.append(pack3_columns(Y, one_tier))
        size += len(parts[-1])
    return b"".join(parts), a.cpu().numpy(), marks
