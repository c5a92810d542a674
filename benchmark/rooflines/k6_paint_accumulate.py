"""K6 (``k6_paint_accumulate``): one painting's co-ancestry tables
(chip_smoke.py:2313-2316, its constants at :253-266). It reads the segments
(12 B each) and their offsets (8 B a haplotype) and writes the four
(n_inds, n_inds) f64 tables and nregions. A weighed (segment, site) pair
takes 29 f64 operations: the weight's product, its add to the normaliser,
three adds (chunk length, chunk count, region sum) and two correctly rounded
divisions (weight / normaliser, / length), each 12 DFMA-equivalents on
sm_90a (a reciprocal seed and its Newton steps, as tools/k6_probe.py counts
them in the SASS of ``__ddiv_rn``)."""

from __future__ import annotations

import torch

from . import PEAKS, bound_s

DIVISION_OPS = 12
PAIR_OPS = 5 + 2 * DIVISION_OPS


def covering_pairs(seg_off: torch.Tensor, sj: torch.Tensor,
                   ss: torch.Tensor, se: torch.Tensor, N: int,
                   ploidy: int) -> torch.Tensor:
    """The weighed pairs of segments (donor sj, start ss, end se; a
    recipient haplotype's in ascending end, seg_off (M + 1,) the range of
    each) as a 0-d tensor on their device (no wait for it): each site k in
    [1, N) at which a segment whose donor is of another individual than its
    recipient is in the recipient's window (pbwtPaint.c:112-137).

    A segment r is there while start_r < k < end_r, unless an earlier
    segment m of its recipient that has not ended (end_m > k) starts at or
    after k: that stops the window's run first. So its sites run from the
    larger of start_r + 1 and min(start_m + 1, end_m) over those m, to
    min(end_r, N). Once every segment has ended, the window rests on the
    last one: from max(end, start + 1) to N it is weighed too."""
    dev = ss.device
    M = seg_off.numel() - 1
    n = ss.numel()
    counts = seg_off[1:] - seg_off[:-1]
    rec = torch.repeat_interleave(torch.arange(M, device=dev), counts,
                                  output_size=n)
    s, e = ss.long(), se.long()
    first = torch.arange(n, device=dev) == seg_off[rec]
    last = torch.arange(n, device=dev) == seg_off[rec + 1] - 1
    # the running max of min(start + 1, end) over each recipient's earlier
    # segments: a recipient's values are lifted above those before it
    lift = rec * (N + 2)
    block = torch.cummax(torch.minimum(s + 1, e) + lift, 0).values - lift
    before = torch.zeros_like(block)
    before[1:] = block[:-1]
    before[first] = 0
    k0 = torch.maximum(s + 1, before)
    live = (torch.minimum(e, torch.full_like(e, N)) - k0).clamp(min=0)
    tail = torch.where(last, (N - torch.maximum(e, s + 1)).clamp(min=0), 0)
    other = sj.long() // ploidy != rec // ploidy
    return torch.where(other, live + tail, 0).sum()


def work(pairs: int, M: int, nseg: int, ploidy: int) -> tuple[int, int]:
    """(bytes, operations) of one painting with ``pairs`` weighed pairs."""
    n_inds = M // ploidy
    return (8 * (M + 1) + 12 * nseg + 8 * (4 * n_inds * n_inds + n_inds),
            PAIR_OPS * pairs)


def bound(pairs: int, M: int, nseg: int, ploidy: int) -> float:
    return bound_s(*work(pairs, M, nseg, ploidy), PEAKS["f64_ops_per_s"])
