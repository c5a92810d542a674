"""One site of the sharded construction's FM position chase: kernel K7 and
its plain twin.

Counterpart of the XLA body of ``pbwt_tpu/parallel/sharding.py:
_fm_group_step`` (:56-78). A rank owns B haplotypes in natural order and
carries each one's position in the global sort order. The packed sorted
column of a site (Mp/32 int32 words, position i at bit i % 32 of word
i // 32, the layout of ``ops/build.py``'s ycols) is the all-reduce of every
rank's bits scattered at their positions; from it each position moves by the
FM map, pos' = u[pos] for a 0 and c + pos - u[pos] for a 1, u[pos] the zeros
before pos and c the zeros of the column. :func:`fm_step` does that for one
site and, fused, scatters the next site's bits at pos' into the next
contribution row (``csrc/fm_step.cu``: a one-block pass of the column's
chunk prefix, then a thread a haplotype). The wrapper runs the kernel on
CUDA tensors and the twin on CPU tensors; it never falls back from one to
the other.
"""

from __future__ import annotations

import torch

from . import kernels
from .match import _popcount32

CHUNK_ROWS = 1024       # positions a chunk of the column's prefix
MAX_ROWS = (1 << 31) - CHUNK_ROWS


def prefix_len(Mp: int) -> int:
    """Ints of K7's chunk prefix of a column of Mp positions."""
    return -(-Mp // CHUNK_ROWS) + 1


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 of the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def fm_step_plain(pos, w, s: int, colw, Mp: int, nxt=None, wn=None,
                  s_next: int = 0, count=None, out=None, pref=None):
    """Plain twin of :func:`fm_step`."""
    p = pos.long()
    pn = p
    if colw is not None:
        cw = colw.long() & 0xFFFFFFFF
        pc = _popcount32(cw)
        before = torch.cumsum(pc, 0) - pc
        c = Mp - pc.sum()
        if pref is not None:
            ends = torch.arange(0, Mp // 32 + 1, CHUNK_ROWS // 32,
                                device=pc.device)
            if ends[-1] != Mp // 32:
                ends = torch.cat([ends, ends.new_tensor([Mp // 32])])
            pref.copy_(torch.cat([pc.new_zeros(1), torch.cumsum(pc, 0)])[ends])
        if p.numel():
            wi = p >> 5
            ones = before[wi] + _popcount32(cw[wi] & ((1 << (p & 31)) - 1))
            pn = torch.where((w.long() >> s) & 1 != 0, c + ones, p - ones)
        if count is not None:
            count.fill_(int(c))
    if nxt is not None:
        y = (wn.long() >> s_next) & 1
        acc = torch.zeros(nxt.numel(), dtype=torch.long, device=nxt.device)
        acc.index_add_(0, pn >> 5, y << (pn & 31))
        nxt |= _wrap32(acc)
    res = out if out is not None else torch.empty_like(pos)
    res.copy_(pn)
    return res


def fm_step(pos, w, s: int, colw, Mp: int, nxt=None, wn=None,
            s_next: int = 0, count=None, out=None, pref=None):
    """One site of the FM position chase on this rank's haplotypes (kernel
    K7).

    pos (B,) int32: the positions of the rank's haplotypes before the site;
    w (B,) int32: their group words, the site at bit s; colw (Mp/32,) int32:
    the all-reduced packed column of the site, or None, when only the
    scatter runs, at pos (the first site's contribution). Returns pos'
    (B,) int32 (in ``out`` if given; ``out`` may be ``pos``). Optionally, in
    place: nxt (Mp/32,) int32, a zeroed contribution row, gets bit s_next of
    wn (B,) ORed in at pos'; count (1,) int32 the zero count; pref
    (:func:`prefix_len` (Mp),) int32 the column's chunk prefix, pref[j] the
    ones in its first 1,024·j positions (the kernel's scratch: given, the
    call allocates nothing, as a captured graph needs). B may be 0: then
    only the prefix and the count are made.
    """
    if pos.device.type == "cpu":
        return fm_step_plain(pos, w, s, colw, Mp, nxt, wn, s_next, count,
                             out, pref)
    res = out if out is not None else torch.empty_like(pos)
    if colw is not None and pref is None:
        pref = torch.empty(prefix_len(Mp), dtype=torch.int32,
                           device=pos.device)
    given = [t for t in (pos, w, colw, nxt, wn, count, res, pref)
             if t is not None]
    dev = kernels.cuda_tensors(*given)
    B = pos.numel()
    if (Mp % 32 or not 0 <= Mp <= MAX_ROWS or res.numel() != B
            or (colw is not None and (colw.numel() != Mp // 32
                                      or w.numel() != B
                                      or pref.numel() != prefix_len(Mp)))
            or (nxt is not None and (nxt.numel() != Mp // 32
                                     or wn.numel() != B))
            or (count is not None and count.numel() != 1)
            or not (0 <= s < 32 and 0 <= s_next < 32)):
        raise ValueError(f"fm_step: inconsistent shapes (B = {B}, Mp = {Mp}, "
                         f"at most {MAX_ROWS} rows in a multiple of 32)")
    if colw is None and res.data_ptr() != pos.data_ptr():
        res.copy_(pos)

    def ptr(t):
        return None if t is None else t.data_ptr()
    kernels.launch("k7_fm_step", dev.index, pos.data_ptr(), res.data_ptr(),
                   ptr(w), int(s), ptr(wn), int(s_next), B, ptr(colw), Mp,
                   ptr(count), ptr(nxt), ptr(pref), kernels.stream(dev))
    return res
