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

from . import kernels, resolve_device
from .partition import _segmented_cummax

TWIN_ELEMENTS = 1 << 24     # (segment, site) pairs a step of the plain twin


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
    normalisers are exact (sums of integers), the tables close."""
    dev = sj.device
    f64 = torch.float64
    n_inds = M // ploidy
    tables = [torch.zeros((n_inds, n_inds), dtype=f64, device=dev)
              for _ in range(4)]
    counts, totlengths, counts2, counts3 = tables
    nregions = torch.zeros(n_inds, dtype=f64, device=dev)
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
    for h0, h1 in _batches(weight, TWIN_ELEMENTS):
        r0, r1 = int(off[h0]), int(off[h1])
        if r1 == r0:
            continue
        R = torch.arange(r0, r1, device=dev)
        L = npairs[r0:r1]
        P = int(L.sum())
        hl = rec[r0:r1] - h0
        nh = h1 - h0
        # this batch's closed regions: their sites, in order, a haplotype
        cb = close[r0:r1]
        marks = torch.zeros((nh, N + 1), dtype=torch.long, device=dev)
        marks.index_put_((hl[cb], e[r0:r1][cb].clamp(min=1)),
                         torch.ones_like(hl[cb]), accumulate=True)
        region = marks.cumsum(1)                      # closes at sites <= k
        ncl_b = ncl[h0:h1]
        rbase = torch.cumsum(ncl_b, 0) - ncl_b
        part = torch.zeros((int(ncl_b.sum()), n_inds), dtype=f64, device=dev)
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
                0, ((rbase[hp] + reg) * n_inds + ind[seg])[shut], tc[shut])
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


def device_bytes(M: int, N: int, ploidy: int, nseg: int) -> int:
    """Device memory :func:`paint_tables_device` takes at most: the
    tables, the segments, the normalisers (8 B a haplotype a site), the
    intervals and cells of :class:`Prepared` (at most nseg + M intervals,
    56 B each with their cells) and the int64 columns :func:`prepare` makes
    on the way (16 an interval)."""
    n_inds, niv = M // ploidy, nseg + M
    return (8 * (4 * n_inds * n_inds + n_inds) + 12 * nseg + 8 * (M + 1)
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

    On the card, :func:`prepare` makes the intervals, cells and closes;
    one call of the kernel entry sums the normalisers of every (haplotype,
    site) into an (M, N) f64 scratch and then walks the cells, a thread a
    cell, each storing its four sums once (cells without a weighed pair
    stay 0).
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
    prep = prepare(seg_off, sj, ss, se, M, N, ploidy, cpr)
    ssum = torch.empty((M, N), dtype=f64, device=dev)
    tables = [torch.zeros((n_inds, n_inds), dtype=f64, device=dev)
              for _ in range(4)]
    kernels.launch("k6_paint_accumulate",
                   *k6_arguments(dev, M, N, prep, ssum, tables))
    return (*tables, prep.nregions)


def upload_segments(sj, ss, se, seg_off, device):
    """The host's segment columns as tensors on ``device``."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (seg_off, sj, ss, se))


def download_tables(tables):
    return tuple(t.cpu().numpy() for t in tables)


def paint_tables_device(sj, ss, se, seg_off, M: int, N: int, ploidy: int,
                        cpr: int, device=None):
    """paint_accumulate on ``device`` from the host's segment columns
    (``algos/paint._collect_match_arrays``); the five tables as numpy
    arrays. Raises, naming -paintSparse, when the dense tables do not fit
    on the card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        need = device_bytes(M, N, ploidy, len(sj))
        # the driver's free memory and what torch's cache holds unused
        free = (torch.cuda.mem_get_info(dev)[0]
                + torch.cuda.memory_reserved(dev)
                - torch.cuda.memory_allocated(dev))
        if need > free:
            raise ValueError(f"-paint's tables need {need} bytes of device "
                             f"memory and {free} are free: use -paintSparse, "
                             "or the host (PBWT_TORCH_DEVICE=0)")
    cols = upload_segments(sj, ss, se, seg_off, dev)
    return download_tables(paint_accumulate(*cols, M, N, ploidy, cpr))
