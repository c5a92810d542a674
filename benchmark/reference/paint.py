"""Plain reference of painting (pbwt's ``-paint``, paintAncestryMatrix at
pbwtPaint.c:56-209).

Segments. A recipient haplotype's within-panel matches are the set-maximal
matches of that haplotype, as a query, against the panel without itself
(``reference/match.py``, all ties kept): segments [s, e) with their donor
haplotype, in ascending end. The other haplotype of the recipient's
individual stays in the panel. This is Durbin's Algorithm 4 (Bioinformatics
30:1266, 2014; pbwtMatch.c:115-142) stated without the PBWT, zero-length
matches included: a haplotype that differs from every other at site e - 1
has matches [e, e) with all of them.

Tables. For each haplotype of a recipient individual, at each site k in
[1, N) (pbwtPaint.c:100-160): the window starts at the segment after those
with end <= k, but never past the last segment, and each segment it passes
is an advance; a region closes at every chunksperregion-th advance, before
the site's additions. The window's contiguous run of segments with start < k
weighs each one whose donor is of another individual by w = (k - s)(e - k)
over the sum of those weights, where that sum is not 0: w / sum is added to
the chunk length of (recipient, donor individual), w / sum / (e - s) to its
chunk count and to the open region's count. A closed region adds its
counts' squares and its counts to ``regionsquaredchunkcounts`` and
``regionchunkcounts``; the region left open at the end adds nothing. Then
each recipient's chunk lengths are scaled to sum to N x ploidy
(:162-175). A row of each table depends only on its recipient's segments,
so the reference computes the rows of the individuals it is given.

Departures from pbwtPaint.c, none of which changes a table beyond f64
rounding:
- pbwt takes the segments from matchMaximalWithin's scan of the PBWT; here
  they follow the definition above. The two give the same sets at every
  end, the panel's first and last sites included (the tests compare them).
- pbwt keeps a recipient's segments that end at the same site in its scan
  order; here they are in donor order. Such segments share their start (the
  longest matches ending at e all start at e - Lmax), so a window's run and
  its weights are the same in either order.
- pbwt adds each weighed pair in turn; here the sums over sites and donors
  run in torch's order, in ``dtype``.
- Once every segment of a recipient has ended, pbwt's window rests on its
  last segment, whose weight at k > e is negative; the reference follows
  pbwt there too. A panel's matches never reach that case: the last segment of
  every haplotype ends at N.

Plain torch on any device; it imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from .match import set_maximal_rows

# (segment, site) elements of a step of a recipient's walk
BLOCK_ELEMENTS = 1 << 25


def segments(cols: torch.Tensor, hap: int) -> np.ndarray:
    """The within-panel matches of haplotype ``hap`` of the panel given as
    its (N, M) uint8 natural-order site columns, on their device: (n, 3)
    int64 rows (donor haplotype, start, end) in ascending (end, donor)."""
    M = cols.shape[1]
    keep = torch.arange(M, device=cols.device) != hap
    rows = set_maximal_rows(cols[:, keep].contiguous(),
                            cols[:, hap][None].contiguous())
    j = rows[:, 1] + (rows[:, 1] >= hap)
    return np.stack([j, rows[:, 2], rows[:, 3]], 1)


def _haplotype(rows: torch.Tensor, me: int, N: int, n_inds: int,
               ploidy: int, cpr: int, dtype, out: list) -> int:
    """Adds one recipient haplotype's walk into the rows ``out`` (counts,
    lengths, squared region counts, region counts; (n_inds,) of dtype);
    returns its closed regions."""
    n, dev = rows.shape[0], rows.device
    if n == 0 or N < 2:
        return 0
    j, s, e = (c.contiguous() for c in rows.unbind(1))
    donor = j // ploidy
    weighed = (donor != me)[:, None]
    idx = torch.arange(n, device=dev)[:, None]
    sites = torch.arange(1, N, device=dev)
    # advances made by each site: the segments ended at or before it, but
    # never past the last
    advances = torch.searchsorted(e, sites, right=True).clamp(max=n - 1)
    region = advances // cpr
    closed = int(region[-1])
    part = torch.zeros((closed + 1, n_inds), dtype=dtype, device=dev)
    counts, lengths, squares, sums = out
    sd, ed = s.to(dtype)[:, None], e.to(dtype)[:, None]
    step = max(1, BLOCK_ELEMENTS // n)
    for b0 in range(0, N - 1, step):
        k = sites[b0:b0 + step]
        first = advances[b0:b0 + step][None]
        # the run: from the window's start to the first segment that
        # starts at or after k
        stops = (s[:, None] >= k[None]) & (idx >= first)
        stop = torch.where(stops, idx, n).min(0).values
        run = (idx >= first) & (idx < stop[None]) & weighed
        kd = k.to(dtype)[None]
        w = torch.where(run, (kd - sd) * (ed - kd), 0.0)
        total = w.sum(0, keepdim=True)
        share = torch.where(run & (total != 0), w / total, 0.0)
        count = torch.where(run, share / (ed - sd), 0.0)
        lengths.index_add_(0, donor, share.sum(1))
        counts.index_add_(0, donor, count.sum(1))
        reg = region[b0:b0 + step][None].expand(n, -1)
        part.index_put_((reg, donor[:, None].expand(-1, k.numel())), count,
                        accumulate=True)
    squares += (part[:closed] ** 2).sum(0)
    sums += part[:closed].sum(0)
    return closed


def tables(segs: dict, individuals, M: int, N: int, ploidy: int, cpr: int,
           dtype=torch.float64, device=None):
    """The painting tables' rows of the recipient ``individuals``, from
    ``segs``: haplotype -> (n, 3) int64 rows (donor, start, end) in
    ascending end, for every haplotype of those individuals (a haplotype
    with no row paints nothing). dtype is the precision of the weights and
    every sum: pbwt's float64, or a lower one to see what it would change.

    Returns (counts, lengths (normalised), squared region counts, region
    counts), each (len(individuals), M // ploidy) of dtype, and nregions
    (len(individuals),) of dtype.
    """
    n_inds = M // ploidy
    out = torch.zeros((4, len(individuals), n_inds), dtype=dtype,
                      device=device)
    nregions = torch.zeros(len(individuals), dtype=dtype, device=device)
    for row, me in enumerate(individuals):
        for h in range(me * ploidy, (me + 1) * ploidy):
            rows = torch.as_tensor(
                np.asarray(segs[h], np.int64).reshape(-1, 3), device=device)
            nregions[row] += _haplotype(rows, me, N, n_inds, ploidy, cpr,
                                        dtype, list(out[:, row]))
    lengths = out[1]
    total = lengths.sum(1, keepdim=True)
    out[1] = torch.where(total != 0, lengths / total * N * ploidy, lengths)
    return (*out, nregions)
