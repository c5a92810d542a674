"""Stable PBWT column partitions: kernels K1 and K2 and their plain twins.

Counterpart of ``pbwt_tpu/ops/partition_pallas.py``. Arrays are flat
``(Mp,)`` int32 tensors in sort order (the TPU's ``(R, 128)`` planes
flattened); any ``Mp`` is accepted. Each wrapper runs its CUDA kernel
(``csrc/partition.cu``) on CUDA tensors and its plain-torch twin on CPU
tensors; it never falls back from one to the other.
"""

from __future__ import annotations

import torch

from . import kernels

GROUP = 32   # sites per packed group word


def _exclusive_zero_rank(key: torch.Tensor):
    """(u, c): u[i] = zeros before position i, c = total zeros (int64)."""
    zero = (key == 0).long()
    incl = torch.cumsum(zero, 0)
    return incl - zero, incl[-1]


def _scatter(dst: torch.Tensor, *planes: torch.Tensor):
    return [torch.empty_like(p).scatter_(0, dst, p) for p in planes]


def _pack_bits(key: torch.Tensor) -> torch.Tensor:
    """0/1 (n,) -> (ceil(n/32),) int32 words, row i at bit i % 32 of word
    i // 32 (the layout of a warp ballot)."""
    n = key.numel()
    rw = (n + 31) // 32
    bits = torch.zeros(rw * 32, dtype=torch.int64, device=key.device)
    bits[:n] = key
    shifts = torch.arange(32, dtype=torch.int64, device=key.device)
    v = (bits.view(rw, 32) << shifts).sum(1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def group_partition_plain(w: torch.Tensor, a: torch.Tensor):
    """Plain twin of :func:`group_partition`."""
    w = w[a.long()]
    n = w.numel()
    idx = torch.arange(n, device=w.device)
    ycols = torch.empty((GROUP, (n + 31) // 32), dtype=torch.int32,
                        device=w.device)
    counts = torch.empty(GROUP, dtype=torch.int32, device=w.device)
    for s in range(GROUP):
        key = (w >> s) & 1
        ycols[s] = _pack_bits(key)
        u, c = _exclusive_zero_rank(key)
        counts[s] = c
        a, w = _scatter(torch.where(key == 0, u, c + idx - u), a, w)
    return a, w, ycols, counts


def group_partition(w: torch.Tensor, a: torch.Tensor):
    """32 stable partitions of one site group (kernel K1).

    w: (Mp,) int32 group words in NATURAL haplotype order, site s of the
    group at bit s; a: (Mp,) int32 prefix array entering the group. The
    words are first aligned to the sort order (w[a]).
    Returns (a', w' in the final sort order, ycols (32, ceil(Mp/32)) int32
    sorted columns packed 32 rows per word, counts (32,) int32 zeros per
    site).
    """
    if w.device.type == "cpu":
        return group_partition_plain(w, a)
    dev = kernels.cuda_tensors(w, a)
    n = w.numel()
    if a.numel() != n:
        raise ValueError(f"group_partition: w has {n} rows, a {a.numel()}")
    rw = (n + 31) // 32
    nb = -(-n // kernels.K1_BLOCK)
    a_out, w_out, a_tmp, w_tmp = (torch.empty_like(a) for _ in range(4))
    ycols = torch.empty((GROUP, rw), dtype=torch.int32, device=dev)
    counts = torch.empty(GROUP, dtype=torch.int32, device=dev)
    sums, offs = (torch.empty(nb * kernels.SUM_INTS, dtype=torch.int32,
                              device=dev) for _ in range(2))
    kernels.launch("k1_group_partition", dev.index, w.data_ptr(),
                   a.data_ptr(), n, a_out.data_ptr(), w_out.data_ptr(),
                   a_tmp.data_ptr(), w_tmp.data_ptr(), ycols.data_ptr(), rw,
                   counts.data_ptr(), sums.data_ptr(), offs.data_ptr(),
                   kernels.stream(dev))
    return a_out, w_out, ycols, counts


def _segmented_cummax(v: torch.Tensor, resets: torch.Tensor) -> torch.Tensor:
    """Inclusive running max of int v restarting at each True in resets
    (the reset applies to its own position). Segments are lifted apart by
    their index above the 32-bit value range, so one cummax serves."""
    seg = torch.cumsum(resets.long(), 0) << 32
    return torch.cummax(seg + (v.long() + (1 << 31)), 0).values - seg \
        - (1 << 31)


def partition_ad_step_plain(a, d, w, s: int, kk: int):
    """Plain twin of :func:`partition_ad_step`."""
    n = a.numel()
    key = (w >> s) & 1
    zero = key == 0
    u, c = _exclusive_zero_rank(key)
    seed = d.long().clone()
    seed[0] = seed[0].clamp(min=kk + 1)
    prev0 = torch.zeros(n, dtype=torch.bool, device=a.device)
    prev1 = torch.zeros_like(prev0)
    prev0[1:] = zero[:-1]
    prev1[1:] = ~zero[:-1]
    pq = torch.where(zero, _segmented_cummax(seed, prev0),
                     _segmented_cummax(seed, prev1)).to(torch.int32)
    idx = torch.arange(n, device=a.device)
    a2, d2, w2 = _scatter(torch.where(zero, u, c + idx - u), a, pq, w)
    d2[0] = kk + 2
    return (a2, d2, w2, u.to(torch.int32),
            c.reshape(1).to(torch.int32))


def partition_ad_step(a, d, w, s: int, kk: int, out=None):
    """One site of the divergence-carrying partition (kernel K2).

    a, d, w: (Mp,) int32 in the current sort order (d without the d[M]
    sentinel); s: bit of the site in w; kk: global site index.
    Returns (a', d', w', u, count): the stable partition of (a, d, w) by
    bit s with d updated as pbwtCursorForwardsAD does (d'[0] = kk+2), the
    exclusive zero ranks u over the pre-site order, and the zero count as
    a (1,) tensor. ``out`` may give the five output tensors (None entries
    are allocated); they must not alias the inputs.
    """
    out = list(out) if out is not None else [None] * 5
    if a.device.type == "cpu":
        res = partition_ad_step_plain(a, d, w, s, kk)
        return tuple(r if o is None else o.copy_(r) for o, r in zip(out, res))
    dev = kernels.cuda_tensors(a, d, w)
    n = a.numel()
    if d.numel() != n or w.numel() != n:
        raise ValueError("partition_ad_step: a, d, w differ in length")
    sizes = [n] * 4 + [1]
    out = [torch.empty(sz, dtype=torch.int32, device=dev) if o is None else o
           for o, sz in zip(out, sizes)]
    kernels.cuda_tensors(a, *out)
    if [o.numel() for o in out] != sizes:
        raise ValueError("partition_ad_step: output sizes differ from input")
    nb = -(-n // kernels.K2_BLOCK)
    sums, carry = (torch.empty(nb * kernels.SUM_INTS, dtype=torch.int32,
                               device=dev) for _ in range(2))
    a2, d2, w2, u, cnt = out
    kernels.launch("k2_partition_ad_step", dev.index, a.data_ptr(),
                   d.data_ptr(), w.data_ptr(), n, int(s), int(kk),
                   a2.data_ptr(), d2.data_ptr(), w2.data_ptr(), u.data_ptr(),
                   cnt.data_ptr(), sums.data_ptr(), carry.data_ptr(),
                   kernels.stream(dev))
    return a2, d2, w2, u, cnt
