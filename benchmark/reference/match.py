"""Plain reference of set-maximal matching (``-matchDynamic``).

For a query z and a panel haplotype x_j, let L_j(e) be the length of the
longest common suffix of z[:e] and x_j[:e], and Lmax(e) its largest value
over the panel. The haplotypes with L_j(e) = Lmax(e) hold the longest
matches that end at e. Where none of them also matches z at site e (or e is
the panel's last site plus one), each of them reports the set-maximal match
(q, j, e - Lmax(e), e): no other haplotype's match contains it. This is
Durbin's Algorithm 5 (Bioinformatics 30:1266, 2014) and pbwtMatch.c's
``matchSequencesDynamic`` stated without the PBWT.

The walk takes a block of sites at a time: L_j(e) = e - P_j(e), where
P_j(e) is one past the last site before e at which z and x_j differ (0 if
none), a running maximum over the block carried from block to block.

Plain torch on any device; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

# (sites x queries x haplotypes) elements of a block
BLOCK_ELEMENTS = 1 << 25


def set_maximal_rows(cols: torch.Tensor, Z: torch.Tensor,
                     one_per_match: bool = False) -> np.ndarray:
    """Set-maximal matches of the (Q, N) uint8 queries Z against the panel
    given as its (N, M) uint8 natural-order site columns, on their device.

    Returns (n, 4) int64 rows (q, haplotype, start, end) sorted by (q, end,
    haplotype). one_per_match keeps only the lowest haplotype of each match:
    the control, a matcher that drops the ties.
    """
    N, M = cols.shape
    Q = Z.shape[0]
    dev = cols.device
    Zt = Z.t().contiguous()                                   # (N, Q)
    carry = torch.zeros((Q, M), dtype=torch.int32, device=dev)   # P before
    hap = torch.arange(M, device=dev)
    step = max(1, BLOCK_ELEMENTS // max(Q * M, 1))
    out = []
    for e0 in range(0, N + 1, step):
        e1 = min(e0 + step, N + 1)
        n = min(e1, N) - e0                                   # real sites
        site = torch.arange(e0, e1, device=dev, dtype=torch.int32)
        differ = cols[e0:e0 + n, None, :] != Zt[e0:e0 + n, :, None]  # (n, Q, M)
        # P after each site of the block, then P before each (exclusive)
        after = torch.where(differ, site[:n, None, None] + 1, 0).cummax(0).values
        after = torch.maximum(after, carry)
        before = torch.cat([carry[None], after])[:e1 - e0]
        L = site[:, None, None] - before                      # (e1-e0, Q, M)
        lmax = L.max(2).values                                # (e1-e0, Q)
        longest = L == lmax[..., None]
        go_on = longest[:n] & ~differ
        report = torch.ones(lmax.shape, dtype=torch.bool, device=dev)
        report[:n] = ~go_on.any(2)
        sel = longest & report[..., None]
        if one_per_match:
            first = torch.where(sel, hap, M).min(2).values
            sel = sel & (hap == first[..., None])
        b, q, j = torch.nonzero(sel, as_tuple=True)
        e = site[b].long()
        out.append(torch.stack([q, j, e - lmax[b, q].long(), e], 1).cpu())
        if n:
            carry = after[-1]
    rows = torch.cat(out).numpy().astype(np.int64)
    return rows[np.lexsort((rows[:, 1], rows[:, 3], rows[:, 0]))]
