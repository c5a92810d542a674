"""Painting's co-ancestry accumulation on the device (kernel K6).

Counterpart of ``pbwt_tpu/ops/paint_jax.py``. Per recipient haplotype and
site k, the maximal-match segments in the reference's window share the
site's weight, w = (k - start)(end - k) over their sum, among their donor
individuals: the chunk lengths add w, the chunk counts w / (end - start), and
so do the running region sums, whose squares and sums are added at every
chunksperregion-th advance of the window (paintAncestryMatrix,
pbwtPaint.c:56-209; the loop of native ``paint_accumulate``). The JAX pass
takes the sums in f32 over (nseg, chunk) grids and rebuilds the region tables
from prefix sums. Kernel ``k6_paint_accumulate`` keeps the host's f64 order
cell by cell: :func:`prepare` turns the segments into the intervals of sites
each one is weighed at, bucketed by table cell (recipient individual, donor
individual), and the region closes of each haplotype; the kernel's first
phase sums the normalisers exactly, its second walks every cell's additions
in the host's order, a thread a cell, so the tables are the host C pass's to
the bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import tracing
from . import build, kernels, partition, resolve_device
from .partition import GROUP, _segmented_cummax

TWIN_ELEMENTS = 1 << 24     # (segment, site) pairs a step of the plain twin
COLLECT_BYTES = 2 << 30     # the collection's tables of a chunk of sites:
                            # A, D and the counts, 12 B a (site, haplotype)


def _windows(seg_off, ss, se, N: int):
    """Per segment: its recipient, and the sites where it is in the window
    of its recipient (pbwtPaint.c:112-137): [k0, k1) while it is live, and
    [t0, N) for the last segment once every segment has expired (the window
    then rests on it). Segments are a recipient's in ascending end.

    A live segment r is in the window at k iff start_r < k < end_r and no
    earlier segment m of the recipient stops the scan first: k >= end_m (it
    was passed) or k > start_m. So k0 is the larger of start_r + 1 and the
    running max of min(end_m, start_m + 1) over the earlier segments."""
    M = seg_off.numel() - 1
    nseg = ss.numel()
    dev = ss.device
    per = seg_off[1:] - seg_off[:-1]
    rec = torch.repeat_interleave(torch.arange(M, device=dev), per,
                                  output_size=nseg)
    pos = torch.arange(nseg, device=dev) - seg_off[rec]
    s, e = ss.long(), se.long()
    c = torch.minimum(e, s + 1)
    first = pos == 0
    reach = torch.zeros_like(c)
    if nseg:
        reach[1:] = _segmented_cummax(c, first)[:-1]
    reach[first] = 0
    k0 = torch.maximum(s + 1, reach)
    k1 = torch.clamp(e, max=N)
    last = pos == per[rec] - 1
    t0 = torch.maximum(torch.maximum(e, s + 1), torch.ones_like(e))
    return rec, pos, last, k0, k1, t0


def _pair_counts(last, k0, k1, t0, other, N: int):
    """(sites live, tail sites) of each segment whose donor is another
    individual."""
    live = torch.where(other, (k1 - k0).clamp(min=0), 0)
    tail = torch.where(other & last, (N - t0).clamp(min=0), 0)
    return live, tail


def covering_pairs(seg_off, sj, ss, se, N: int, ploidy: int) -> int:
    """The (segment, site) pairs that painting weighs: a segment of another
    individual in its recipient's window at a site."""
    rec, _, last, k0, k1, t0 = _windows(seg_off, ss, se, N)
    other = sj.long() // ploidy != rec // ploidy
    live, tail = _pair_counts(last, k0, k1, t0, other, N)
    return int((live + tail).sum())


def _batches(weight: np.ndarray, budget: int) -> list[tuple[int, int]]:
    """[h0, h1) runs of haplotypes whose weights add up to about budget."""
    cw = np.cumsum(weight)
    cut = np.flatnonzero(np.diff((cw - 1) // max(budget, 1))) + 1
    edges = [0, *cut.tolist(), len(weight)]
    return [(a, b) for a, b in zip(edges[:-1], edges[1:]) if b > a]


def paint_accumulate_plain(seg_off, sj, ss, se, M: int, N: int, ploidy: int,
                           cpr: int):
    """Plain twin of :func:`paint_accumulate`: every weighed (segment, site)
    pair at once for a batch of recipient haplotypes, the normalisers summed
    a (haplotype, site) with ``index_add_``, and the region sums a (closed
    region, donor individual). f64 in another order than the host's: the
    normalisers are exact (sums of integers), the tables close. Its two
    stages are the spans ``ops.paint.prepare`` (the windows and closes)
    and ``ops.paint.k6`` (the sums); it counts the intervals and cells that
    :func:`prepare` makes, from its own windows."""
    dev = sj.device
    f64 = torch.float64
    n_inds = M // ploidy
    tables = [torch.zeros((n_inds, n_inds), dtype=f64, device=dev)
              for _ in range(4)]
    counts, totlengths, counts2, counts3 = tables
    nregions = torch.zeros(n_inds, dtype=f64, device=dev)
    with tracing.span("ops.paint.prepare"):
        rec, pos, last, k0, k1, t0 = _windows(seg_off, ss, se, N)
        s, e = ss.long(), se.long()
        ind = sj.long() // ploidy
        me = rec // ploidy
        live, tail = _pair_counts(last, k0, k1, t0, ind != me, N)
        npairs = live + tail
        # a region closes at the site of every cpr-th advance of the window
        close = (((pos + 1) % cpr) == 0) & ~last & (e.clamp(min=1) <= N - 1)
        ncl = torch.zeros(M, dtype=torch.long, device=dev)
        ncl.index_add_(0, rec[close], torch.ones_like(rec[close]))
        nregions.index_add_(0, torch.arange(n_inds * ploidy, device=dev)
                            // ploidy, ncl[:n_inds * ploidy].to(f64))
        per_hap = torch.zeros(M, dtype=torch.long, device=dev)
        per_hap.index_add_(0, rec, npairs)
        weight = (per_hap + ncl * n_inds + N).cpu().numpy()
        off = seg_off.cpu().numpy()
        # an interval is a segment with a weighed pair; a cell, a
        # (recipient, donor) individual pair with one
        weighed = npairs > 0
        tracing.count("ops.paint.intervals", int(weighed.sum()))
        tracing.count("ops.paint.cells", torch.unique(
            (me * n_inds + ind)[weighed]).numel())
    with tracing.span("ops.paint.k6"):
        for h0, h1 in _batches(weight, TWIN_ELEMENTS):
            r0, r1 = int(off[h0]), int(off[h1])
            if r1 == r0:
                continue
            R = torch.arange(r0, r1, device=dev)
            L = npairs[r0:r1]
            P = int(L.sum())
            hl = rec[r0:r1] - h0
            nh = h1 - h0
            # this batch's closed regions: their sites, in order, a
            # haplotype
            cb = close[r0:r1]
            marks = torch.zeros((nh, N + 1), dtype=torch.long, device=dev)
            marks.index_put_((hl[cb], e[r0:r1][cb].clamp(min=1)),
                             torch.ones_like(hl[cb]), accumulate=True)
            region = marks.cumsum(1)                  # closes at sites <= k
            ncl_b = ncl[h0:h1]
            rbase = torch.cumsum(ncl_b, 0) - ncl_b
            part = torch.zeros((int(ncl_b.sum()), n_inds), dtype=f64,
                               device=dev)
            if P:
                seg = torch.repeat_interleave(R, L, output_size=P)
                at = torch.arange(P, device=dev) - (torch.cumsum(L, 0) - L)[
                    seg - r0]
                lv = live[seg]
                k = torch.where(at < lv, k0[seg] + at, t0[seg] + at - lv)
                hp = rec[seg] - h0
                w = ((k - s[seg]) * (e[seg] - k)).to(f64)
                ssum = torch.zeros(nh * N, dtype=f64, device=dev)
                ssum.index_add_(0, hp * N + k, w)
                ssum = ssum[hp * N + k]
                ok = ssum != 0
                wn = torch.where(ok, w / ssum, 0.0)
                tc = torch.where(ok, wn / (e[seg] - s[seg]).to(f64), 0.0)
                cell = me[seg] * n_inds + ind[seg]
                totlengths.view(-1).index_add_(0, cell, wn)
                counts.view(-1).index_add_(0, cell, tc)
                reg = region[hp, k]
                shut = reg < ncl_b[hp]
                part.view(-1).index_add_(
                    0, ((rbase[hp] + reg) * n_inds + ind[seg])[shut],
                    tc[shut])
            owner = (h0 + torch.repeat_interleave(
                torch.arange(nh, device=dev), ncl_b,
                output_size=part.shape[0])) // ploidy
            counts2.index_add_(0, owner, part * part)
            counts3.index_add_(0, owner, part)
    return counts, totlengths, counts2, counts3, nregions


class Prepared(NamedTuple):
    """K6's inputs (:func:`prepare`). An interval is a segment of another
    individual and the sites [a, b) at which it is in its recipient's window:
    while it is live and, for the last of its haplotype, on to N (the window
    then rests on it)."""
    hap_off: torch.Tensor     # (M + 1,) int64: each haplotype's intervals
    hap_iv: torch.Tensor      # (niv, 4) int32: a, b, start, end
    sched: torch.Tensor       # (ncells,) int32: the cells, longest first
    cell_off: torch.Tensor    # (ncells + 1,) int64: each cell's intervals
    cell_key: torch.Tensor    # (ncells,) int64: recipient * n_inds + donor
    cell_iv: torch.Tensor     # (niv, 4) int32: hap_iv in cell order
    cell_hap: torch.Tensor    # (niv,) int32: their haplotypes
    close_off: torch.Tensor   # (M + 1,) int64: each haplotype's closes
    close_site: torch.Tensor  # (ncloses,) int32: the sites, ascending
    nregions: torch.Tensor    # (n_inds,) f64: closes an individual


def _offsets(owner: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1,) int64 offsets of the runs of owner, ascending, in [0, n)."""
    return torch.searchsorted(owner, torch.arange(n + 1, device=owner.device))


def prepare(seg_off, sj, ss, se, M: int, N: int, ploidy: int,
            cpr: int) -> Prepared:
    """The intervals, cells and region closes of K6, by index arithmetic
    alone (no f64 sum or quotient is taken here).

    A haplotype's intervals keep the segment order, so their ends b do not
    decrease, and the intervals in the window at a site are a run of them.
    A stable sort by cell keeps each cell's intervals in (haplotype,
    segment) order: the order in which the host adds into that cell. A region closes at site max(end, 1) of every
    cpr-th segment but a haplotype's last, if that site is below N: there
    the host's window passes it, and the open region is flushed before the
    site's additions. The cells are scheduled by the power of two of their
    weighed pairs, largest first, then in key order."""
    if M % ploidy:
        raise ValueError(f"paint_accumulate: {M} haplotypes are not whole "
                         f"individuals of ploidy {ploidy}")
    dev = sj.device
    n_inds = M // ploidy
    i32 = torch.int32
    rec, pos, last, k0, k1, t0 = _windows(seg_off, ss, se, N)
    e = se.long()
    ind, me = sj.long() // ploidy, rec // ploidy
    other = ind != me
    # a live interval needs end >= start + 2, and then its tail (the last
    # segment's) starts at t0 = end = k1: the two make one interval
    live = other & (k0 < k1)
    tail = other & last & (t0 < N)
    sid = torch.nonzero(live | tail).squeeze(1)
    a = torch.where(live, k0, t0)[sid]
    b = torch.where(tail, N, k1)[sid]
    hap = rec[sid]
    # an interval's four fields are one 16-byte element: one load in K6,
    # and one gather into cell order
    iv = torch.empty((sid.numel(), 4), dtype=i32, device=dev)
    for col, x in enumerate((a, b, ss[sid], se[sid])):
        iv[:, col] = x

    key = me[sid] * n_inds + ind[sid]
    if n_inds * n_inds < 1 << 31:       # a radix sort of half the passes
        key = key.to(i32)
    key, perm = torch.sort(key, stable=True)
    cell_key, count = torch.unique_consecutive(key, return_counts=True)
    cell_off = torch.zeros(count.numel() + 1, dtype=torch.long, device=dev)
    cell_off[1:] = torch.cumsum(count, 0)
    done = torch.zeros(sid.numel() + 1, dtype=torch.long, device=dev)
    done[1:] = torch.cumsum((b - a)[perm], 0)
    pairs = done[cell_off[1:]] - done[cell_off[:-1]]
    powers = torch.ones(62, dtype=torch.long, device=dev) << torch.arange(
        1, 63, device=dev)
    bucket = torch.bucketize(pairs, powers, right=True).to(i32)
    sched = torch.sort(-bucket, stable=True).indices.to(i32)

    shut = torch.nonzero((((pos + 1) % cpr) == 0) & ~last
                         & (e.clamp(min=1) <= N - 1)).squeeze(1)
    close_off = _offsets(rec[shut], M)
    ncl = close_off[1:] - close_off[:-1]
    return Prepared(
        _offsets(hap, M), iv, sched, cell_off, cell_key.long(),
        iv.view(torch.complex128)[perm].view(i32).view(-1, 4),
        hap[perm].to(i32), close_off,
        e[shut].clamp(min=1).to(i32),
        ncl.view(n_inds, ploidy).sum(1).to(torch.float64))


def segment_bytes(M: int, nseg: int) -> int:
    """Device bytes of the segments: sj, ss, se and seg_off."""
    return 12 * nseg + 8 * (M + 1)


def device_bytes(M: int, N: int, ploidy: int, nseg: int) -> int:
    """Device memory :func:`paint_tables_device` takes at most: the
    segments (:func:`segment_bytes`; on a card they are already there, the
    collection's scratch freed), the tables, the normalisers (8 B a
    haplotype a site), the intervals and cells of :class:`Prepared` (at
    most nseg + M intervals, 56 B each with their cells) and the int64
    columns :func:`prepare` makes on the way (16 an interval)."""
    n_inds, niv = M // ploidy, nseg + M
    return (8 * (4 * n_inds * n_inds + n_inds) + segment_bytes(M, nseg)
            + 8 * M * N + 56 * niv + 4 * nseg + 16 * (M + 1) + 128 * niv)


def k6_arguments(dev, M: int, N: int, prep: Prepared, ssum, tables,
                 phases: int = 3) -> tuple:
    """The arguments of the C entry k6_paint_accumulate: phases 1 (the
    normalisers into ssum), 2 (the cells into the tables) or 3 (both)."""
    ptr = [t.data_ptr() for t in prep[:-1]]
    return (dev.index, M, N, phases, ptr[0], ptr[1], prep.sched.numel(),
            *ptr[2:], ssum.data_ptr(),
            *(t.data_ptr() for t in tables), kernels.stream(dev))


def paint_accumulate(seg_off, sj, ss, se, M: int, N: int, ploidy: int,
                     cpr: int):
    """The co-ancestry tables of painting (kernel K6).

    seg_off (M+1,) int64: the range of each recipient haplotype's segments;
    sj, ss, se (nseg,) int32: donor haplotype, start and end, a recipient's
    in report order (ascending end); ploidy haplotypes an individual; a
    region closes at every cpr-th advance of a recipient's window. Returns
    (counts, totlengths, counts2, counts3) (n_inds, n_inds) float64 and
    nregions (n_inds,) float64, n_inds = M // ploidy: what native
    ``paint_accumulate`` writes with no length cutoff, before the lengths
    are normalised.

    On the card, :func:`prepare` makes the intervals, cells and closes
    (the span ``ops.paint.prepare``); one call of the kernel entry (the
    span ``ops.paint.k6``, its enqueue) sums the normalisers of every
    (haplotype, site) into an (M, N) f64 scratch and then walks the cells,
    a thread a cell, each storing its four sums once (cells without a
    weighed pair stay 0). On CPU tensors the twin takes its place.
    """
    if sj.device.type == "cpu":
        return paint_accumulate_plain(seg_off, sj, ss, se, M, N, ploidy, cpr)
    f64 = torch.float64
    dev = kernels.typed_cuda_tensors((seg_off, torch.int64), (sj, torch.int32),
                                     (ss, torch.int32), (se, torch.int32))
    if (seg_off.numel() != M + 1 or ss.numel() != sj.numel()
            or se.numel() != sj.numel() or cpr < 1 or ploidy < 1):
        raise ValueError("paint_accumulate: inconsistent shapes")
    n_inds = M // ploidy
    with tracing.span("ops.paint.prepare"):
        prep = prepare(seg_off, sj, ss, se, M, N, ploidy, cpr)
    # both sizes are on the host: nonzero and unique_consecutive waited
    tracing.count("ops.paint.intervals", prep.hap_iv.shape[0])
    tracing.count("ops.paint.cells", prep.cell_key.numel())
    with tracing.span("ops.paint.k6"):
        ssum = torch.empty((M, N), dtype=f64, device=dev)
        tables = [torch.zeros((n_inds, n_inds), dtype=f64, device=dev)
                  for _ in range(4)]
        kernels.launch("k6_paint_accumulate",
                       *k6_arguments(dev, M, N, prep, ssum, tables))
    return (*tables, prep.nregions)


def _extents(A, D, ycols, k0: int, N: int):
    """Each (site k0 + r, position i)'s report as max_within_impl's scan
    makes it, for every r and i at once, the scans stepped together: the
    rows [lo, i) above i (from d[i]) and (i, hi) below it (from d[i+1]),
    none (hi - lo - 1 = 0) where an allele stopped a scan. Returns (lo, hi,
    d[i], d[i+1]) as (nk, M) int64, nk = A.shape[0]."""
    nk, M = A.shape
    dev = A.device
    k = k0 + torch.arange(nk, device=dev)[:, None]
    d = torch.cat((k + 1, D[:, 1:].long(), k + 1), 1)     # (nk, M + 1)
    n_cols = max(0, min(nk, N - k0))
    bits = torch.arange(GROUP, dtype=torch.int64, device=dev)
    y = torch.zeros((nk, M), dtype=torch.int64, device=dev)
    y[:n_cols] = ((ycols[:n_cols].long()[:, :, None] >> bits) & 1).reshape(
        n_cols, ycols.shape[1] * GROUP)[:, :M]
    check = (k < N).expand(nk, M)
    i = torch.arange(M, device=dev).expand(nk, M)
    di, di1 = d[:, :M], d[:, 1:]
    stop = torch.zeros((nk, M), dtype=torch.bool, device=dev)
    ends = []
    for step, start, bound, first in ((-1, i - 1, di, di <= di1),
                                      (1, i + 1, di1, di >= di1)):
        j, live = start.clone(), first.clone()
        while bool(live.any()):
            # up: while d[j + 1] <= d[i]; down: while d[j] <= d[i + 1]
            live &= d.gather(1, (j + (step < 0)).clamp(0, M)) <= bound
            hit = live & check & (y.gather(1, j.clamp(0, M - 1)) == y)
            stop |= hit
            live &= ~hit
            j = torch.where(live, j + step, j)
        ends.append(j)
    lo = torch.where(di <= di1, ends[0] + 1, i)
    hi = torch.where(di >= di1, ends[1], i + 1)
    lo = torch.where(stop, i, lo)
    hi = torch.where(stop, i + 1, hi)
    return lo, hi, di, di1


def max_within_count_plain(A, D, ycols, k0: int, N: int, counts):
    """Plain twin of :func:`max_within_count`."""
    lo, hi, _, _ = _extents(A, D, ycols, k0, N)
    counts.t().scatter_(1, A.long(), (hi - lo - 1).to(counts.dtype))
    return counts


def max_within_fill_plain(A, D, ycols, k0: int, N: int, counts, base, sj,
                          ss, se):
    """Plain twin of :func:`max_within_fill`."""
    nk, M = A.shape
    dev = A.device
    lo, hi, di, di1 = (t.reshape(-1) for t in _extents(A, D, ycols, k0, N))
    c = hi - lo - 1
    rec = A.reshape(-1).long()
    r = torch.arange(nk * M, device=dev) // M
    i = torch.arange(nk * M, device=dev) % M
    first = base[rec] + counts.t().gather(1, A.long()).reshape(-1).long() - c
    total = int(c.sum())
    at = torch.repeat_interleave(torch.arange(nk * M, device=dev), c,
                                 output_size=total)
    t = torch.arange(total, device=dev) - (torch.cumsum(c, 0) - c)[at]
    nup = (i - lo)[at]
    up = t < nup
    j = torch.where(up, lo[at] + t, i[at] + 1 + t - nup)
    dst = first[at] + t
    sj[dst] = A.reshape(-1)[r[at] * M + j]
    ss[dst] = torch.where(up, di[at], di1[at]).to(ss.dtype)
    se[dst] = (k0 + r[at]).to(se.dtype)
    return sj, ss, se


def max_within_count(A, D, ycols, k0: int, N: int, counts):
    """The set-maximal within-panel matches' counting pass (kernel K9
    ``k9_max_within``) over sites k0 .. k0 + nk - 1 of a panel of M
    haplotypes and N sites, nk = A.shape[0] <= N + 1 - k0 (site N is the
    flush, with no allele): A, D (nk, M) int32 the prefix and divergence
    arrays before each site (:func:`partition.ad_table`'s rows; D's column
    0 is not read), ycols the packed sorted columns of the sites below N
    from k0 on. Fills counts (M, nk) int32: [a, r] the reports of recipient
    a at site k0 + r, as max_within_impl of the host C runtime makes them.
    On CPU tensors the plain twin."""
    if A.device.type == "cpu":
        return max_within_count_plain(A, D, ycols, k0, N, counts)
    return _k9(A, D, ycols, k0, N, counts)


def max_within_fill(A, D, ycols, k0: int, N: int, counts, base, sj, ss,
                    se):
    """K9's filling pass over the sites of :func:`max_within_count`, with
    counts turned into their inclusive sums along each recipient's row, and
    base (M,) int64 each recipient's first slot: writes each
    report's donor haplotype, start and end (sj, ss, se int32) in the host's
    order, a recipient's by site, within a site the rows above it and then
    those below, each ascending. On CPU tensors the plain twin."""
    if A.device.type == "cpu":
        return max_within_fill_plain(A, D, ycols, k0, N, counts, base, sj,
                                     ss, se)
    return _k9(A, D, ycols, k0, N, counts, base, sj, ss, se)


def _k9(A, D, ycols, k0, N, counts, base=None, sj=None, ss=None, se=None):
    dev = kernels.cuda_tensors(A, D, ycols, counts)
    nk, M = A.shape
    if D.shape != A.shape or counts.shape != (M, nk):
        raise ValueError("max_within: A, D and counts differ in shape")
    if base is not None:
        kernels.typed_cuda_tensors((base, torch.int64), (sj, torch.int32),
                                   (ss, torch.int32), (se, torch.int32))
        if not sj.numel():
            return sj, ss, se
    kernels.launch("k9_max_within", dev.index, A.data_ptr(), D.data_ptr(),
                   ycols.data_ptr(), ycols.shape[1], M, nk, int(k0), int(N),
                   counts.data_ptr(),
                   *((None,) * 4 if base is None else
                     (base.data_ptr(), sj.data_ptr(), ss.data_ptr(),
                      se.data_ptr())), kernels.stream(dev))
    return counts if base is None else (sj, ss, se)


def collect_bytes(M: int, N: int, nz: int) -> int:
    """Device memory :func:`collect_matches` takes at most besides the
    segments: the pack3 bytes, the columns, and the larger of the decode's
    row counts and first rows (12 B a byte) and a chunk's tables (A, D and
    the counts of at most COLLECT_BYTES // (12 M) sites, A and D one row
    more). At 5,008 haplotypes it stays below :func:`device_bytes` from
    16,384 sites to the dense route's 500,000, so K6's scratch still sets
    the route's peak and its limit of sites."""
    chunk = min(N + 1, _chunk_sites(M))
    return (nz + 4 * N * -(-M // GROUP)
            + max(12 * nz, 4 * M * (3 * chunk + 2)))


def _chunk_sites(M: int) -> int:
    return max(1, COLLECT_BYTES // (12 * M))


def collect_matches(yz: bytes, M: int, N: int, a0, device):
    """The set-maximal within-panel matches of a panel, collected on
    ``device`` (a CUDA card; a CPU device runs the kernels' plain twins):
    (sj, ss, se int32, seg_off int64 (M + 1,)) tensors there, the host C
    runtime's ``max_within_bucketed`` exactly, in its order. yz: the
    panel's pack3 bytes (M >= 2 haplotypes, N sites), a0 its start prefix
    array (the panel's ``aFstart``; None for the identity). Raises, naming
    -paintSparse, where :func:`collect_bytes` do not fit on the card.

    The bytes and a0 are uploaded (span ``ops.paint.collect.upload``) and
    decoded into packed sorted columns by ``k1_decode_columns``
    (``.decode``). Then, in chunks of sites whose tables fit COLLECT_BYTES
    (one at 5,008 haplotypes up to 35,000 sites), (a, d) carried from one to
    the next: K2's ``k2_partition_ad_table`` writes every site's (a, d)
    (``.trajectory``), K9's counting pass each (recipient, site)'s reports,
    summed over the sites along each recipient's row in place (``.count``),
    and K9's filling pass the reports in (recipient, site) order
    (``.fill``; with several chunks, one stable placement by recipient
    follows). Nothing is kept on the device after the call but the
    segments."""
    dev = torch.device(device)
    i32 = torch.int32
    check_room(collect_bytes(M, N, len(yz)), dev, "match collection")
    if a0 is None:
        a0 = np.arange(M, dtype=np.int32)
    with tracing.span("ops.paint.collect.upload"):
        z = torch.frombuffer(bytearray(yz), dtype=torch.uint8) if yz else (
            torch.empty(0, dtype=torch.uint8))
        z = z.to(dev)
        a = torch.from_numpy(np.ascontiguousarray(a0, np.int32)).to(dev)
    with tracing.span("ops.paint.collect.decode"):
        ycols = build.decode_columns(z, N, M)
        del z
    chunk = min(N + 1, _chunk_sites(M))
    A = torch.empty((chunk + 1, M), dtype=i32, device=dev)
    D = torch.empty_like(A)
    A[0], D[0] = a, 0
    counts = torch.empty(chunk * M, dtype=i32, device=dev)
    parts = []
    for k0 in range(0, N + 1, chunk):
        nk = min(chunk, N + 1 - k0)     # sites of reports, N the flush
        ns = min(nk, N - k0)            # sites of the trajectory
        if k0:
            A[0], D[0] = A[chunk], D[chunk]
        with tracing.span("ops.paint.collect.trajectory"):
            partition.ad_table(ycols[k0:k0 + ns], A[:ns + 1], D[:ns + 1], k0)
        with tracing.span("ops.paint.collect.count"):
            cnt = counts[:M * nk].view(M, nk)
            max_within_count(A[:nk], D[:nk], ycols[k0:], k0, N, cnt)
            tot = cnt.sum(1, dtype=torch.int64)
            cnt.cumsum_(1)
            off = torch.zeros(M + 1, dtype=torch.int64, device=dev)
            torch.cumsum(tot, 0, out=off[1:])
            n, top = torch.stack((off[-1], tot.max())).tolist()
            if top >= 1 << 31:
                raise ValueError(f"max_within: {top} matches of one "
                                 "haplotype in a chunk of sites")
        with tracing.span("ops.paint.collect.fill"):
            seg = [torch.empty(n, dtype=i32, device=dev) for _ in range(3)]
            max_within_fill(A[:nk], D[:nk], ycols[k0:], k0, N, cnt, off[:-1],
                            *seg)
        parts.append((tot, off, *seg))
    if len(parts) == 1:
        tot, off, sj, ss, se = parts[0]
        return sj, ss, se, off
    with tracing.span("ops.paint.collect.fill"):
        return _placed(parts, M)


def _placed(parts, M: int):
    """The chunks' segments, each in (recipient, site) order, placed by
    recipient, the chunks in order: (sj, ss, se, seg_off)."""
    dev = parts[0][0].device
    tots = torch.stack([p[0] for p in parts])            # (chunks, M)
    seg_off = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    torch.cumsum(tots.sum(0), 0, out=seg_off[1:])
    prior = torch.cumsum(tots, 0) - tots
    out = [torch.empty(int(seg_off[-1]), dtype=torch.int32, device=dev)
           for _ in range(3)]
    recs = torch.arange(M, device=dev)
    for c, (tot, off, *seg) in enumerate(parts):
        n = seg[0].numel()
        rec = torch.repeat_interleave(recs, tot, output_size=n)
        dst = (torch.arange(n, device=dev) - off[rec] + seg_off[rec]
               + prior[c, rec])
        for o, x in zip(out, seg):
            o[dst] = x
    return (*out, seg_off)


def upload_segments(sj, ss, se, seg_off, device):
    """The host's segment columns as tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (seg_off, sj, ss, se))


def download_tables(tables):
    return tuple(t.cpu().numpy() for t in tables)


def check_room(need: int, dev: torch.device, what: str) -> None:
    """Raise, naming -paintSparse, where ``need`` bytes are more than the
    card's free memory and what torch's cache holds unused."""
    if dev.type != "cuda":
        return
    free = (torch.cuda.mem_get_info(dev)[0] + torch.cuda.memory_reserved(dev)
            - torch.cuda.memory_allocated(dev))
    if need > free:
        raise ValueError(f"-paint's {what} need {need} bytes of device "
                         f"memory and {free} are free: use -paintSparse, "
                         "or the host (PBWT_TORCH_DEVICE=0)")


def paint_tables_device(sj, ss, se, seg_off, M: int, N: int, ploidy: int,
                        cpr: int, device=None):
    """paint_accumulate on ``device`` from the segment columns: the host's
    (``algos/paint._collect_match_arrays``), uploaded first, or tensors
    already there (:func:`collect_matches`); the five tables as numpy
    arrays. Raises, naming -paintSparse, when the dense tables do not fit
    on the card."""
    dev = resolve_device(device)
    there = isinstance(sj, torch.Tensor)
    need = device_bytes(M, N, ploidy, len(sj))
    check_room(need - segment_bytes(M, len(sj)) * there, dev, "tables")
    if there:
        cols = tuple(t.to(dev) for t in (seg_off, sj, ss, se))
    else:
        with tracing.span("ops.paint.upload"):
            cols = upload_segments(sj, ss, se, seg_off, dev)
    tables = paint_accumulate(*cols, M, N, ploidy, cpr)
    with tracing.span("ops.paint.download"):        # waits for K6
        return download_tables(tables)
