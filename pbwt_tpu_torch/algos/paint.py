"""ChromoPainter-style local-ancestry painting (pbwtPaint.c): -paint and
-paintSparse.

Counterpart of ``pbwt_tpu/algos/paint.py``. Co-ancestry chunk counts and
lengths from the maximal within-panel matches with (k-start)*(end-k)
positional weighting, region-binned squared counts, and the SparsePainter
streaming variant (Yang et al., Nat Comms 16:2742, 2025). The matches are
collected on the host (the C scan into per-recipient buckets); the dense
tables are accumulated by kernel K6 on the device engine when
:func:`pbwt_tpu_torch.ops.device_requested` says so, else by the host C
pass; ``outputlocal`` takes the reference's loop, which writes the
local-ancestry file. K6 and the C pass give the same bits. -paintSparse takes
the per-individual C pass and writes its five streams through zlib as
zlib's ``gzopen("w6")`` does (:class:`_GzipStream`), byte for byte.
"""

from __future__ import annotations

import zlib

import numpy as np

from ..core import native
from ..core.pbwt import PBWT
from ..ops import device_requested
from ..utils import fopen_tag, time_update
from . import match as matchmod


def _collect_matches(p: PBWT):
    """Each haplotype's maximal within-panel matches as (jRef, start, end)
    lists in report order, for the reference's loop."""
    max_match: list[list[tuple[int, int, int]]] = [[] for _ in range(p.M)]
    matchmod.match_maximal_within(
        p, lambda ai, bi, s, e: max_match[ai].append((bi, s, e)))
    return max_match


def _collect_match_arrays(p: PBWT):
    """Flattened per-hap match segments (seg_j, seg_s, seg_e, seg_off) in
    the reference's per-recipient report order, without Python lists: the
    C scan straight into per-recipient buckets, or, for a panel without
    pack3 bytes, its rows bucketed in C."""
    a0 = (p.aFstart if p.aFstart is not None
          else np.arange(p.M, dtype=np.int32))
    if p.yz:
        return native.max_within_bucketed(p.yz, p.M, p.N, a0)
    rows = native.max_within(p.decoded(True), a0)
    # C counting sort by recipient: one pass over the int64 rows
    n = len(rows)
    sj = native.pooled_view((n,), np.int32, "paint:sj")
    ss = native.pooled_view((n,), np.int32, "paint:ss")
    se = native.pooled_view((n,), np.int32, "paint:se")
    seg_off = np.zeros(p.M + 1, np.int64)
    native.get_lib().bucket_rows(np.ascontiguousarray(rows.reshape(-1)), n,
                                 p.M, sj, ss, se, seg_off)
    return sj, ss, se, seg_off


def _paint_device(p: PBWT, chunksperregion: int, ploidy: int, device=None):
    """The four tables and nregions by kernel K6 (or its twin on a named
    CPU) from the host's segments, uploaded in report order."""
    from ..ops import paint as device_paint
    sj, ss, se, seg_off = _collect_match_arrays(p)
    return device_paint.paint_tables_device(sj, ss, se, seg_off, p.M, p.N,
                                            ploidy, chunksperregion,
                                            device=device)


def _check_ploidy(p: PBWT, ploidy: int) -> None:
    if ploidy < 1 or p.M % ploidy:
        raise ValueError(f"painting: {p.M} haplotypes are not whole "
                         f"individuals of ploidy {ploidy}")


def paint_ancestry_matrix(p: PBWT, file_root: str, chunksperregion: int = 100,
                          ploidy: int = 2, outputlocal: int = 0,
                          device=None) -> None:
    """paintAncestryMatrix (pbwtPaint.c:56-209)."""
    _check_ploidy(p, ploidy)
    n_inds = p.M // ploidy
    map_ih = np.arange(p.M) // ploidy
    if not outputlocal and device_requested():
        counts, totlengths, counts2, counts3, nregions = _paint_device(
            p, chunksperregion, ploidy, device)
    elif not outputlocal:
        counts, totlengths, counts2, counts3 = (np.zeros((n_inds, n_inds))
                                                for _ in range(4))
        nregions = np.zeros(n_inds)
        sj, ss, se, seg_off = _collect_match_arrays(p)
        native.get_lib().paint_accumulate(
            sj, ss, se, seg_off, p.M, p.N, n_inds, ploidy, chunksperregion,
            -1.0, counts.reshape(-1), counts2.reshape(-1),
            counts3.reshape(-1), totlengths.reshape(-1), nregions,
            np.zeros(n_inds))
    else:
        counts, totlengths, counts2, counts3, nregions = _paint_loop(
            p, chunksperregion, map_ih, n_inds, outputlocal, file_root)
    _write_tables(file_root, counts, totlengths, counts2, counts3, nregions,
                  p.N, ploidy)
    time_update()


def _paint_loop(p: PBWT, chunksperregion: int, map_ih: np.ndarray,
                n_inds: int, outputlocal: int, file_root: str):
    """The reference's loop (pbwtPaint.c:100-160), with the local-ancestry
    file of ``outputlocal``."""
    counts = np.zeros((n_inds, n_inds))
    counts2 = np.zeros((n_inds, n_inds))
    counts3 = np.zeros((n_inds, n_inds))
    totlengths = np.zeros((n_inds, n_inds))
    nregions = np.zeros(n_inds)
    part_counts = np.zeros(n_inds)
    flp = None
    if outputlocal:
        flp = fopen_tag(file_root, "localancestry.out", "w")
        flp.write("pos" + "".join(f" IND{i + 1}" for i in range(n_inds))
                  + "\n")
    max_match = _collect_matches(p)
    for i in range(p.M):
        if outputlocal:
            localsum = np.zeros((n_inds, p.N))
        mm = max_match[i]
        if not mm:
            mm = [(i, 0, 0)]
        m1 = 0
        n1 = 1
        m_stop = len(mm) - 1
        part_counts[:] = 0.0
        me = map_ih[i]
        for k in range(1, p.N):
            while mm[m1][2] <= k and m1 < m_stop:
                if n1 % chunksperregion == 0:
                    mask = np.arange(n_inds) != me
                    counts2[me][mask] += part_counts[mask] ** 2
                    counts3[me][mask] += part_counts[mask]
                    part_counts[:] = 0.0
                    nregions[me] += 1.0
                m1 += 1
                n1 += 1
            ssum = 0.0
            mlist = []
            m = m1
            while m <= m_stop and mm[m][1] < k:
                jm, sm, em = mm[m]
                if map_ih[jm] != me:
                    mlist.append((jm, sm, em))
                    ssum += (k - sm) * (em - k)
                m += 1
            if ssum:
                for jm, sm, em in mlist:
                    w = (k - sm) * (em - k) / ssum
                    if outputlocal:
                        localsum[map_ih[jm]][k] += w
                    totlengths[me][map_ih[jm]] += w
                    thiscount = w / (em - sm)
                    counts[me][map_ih[jm]] += thiscount
                    part_counts[map_ih[jm]] += thiscount
        if outputlocal:
            flp.write(f"HAP {i + 1} IND{me + 1}\n")
            for k in range(p.N - 1, -1, -1):
                flp.write(str(p.sites[k].x))
                for j in range(n_inds):
                    flp.write(f" {localsum[j][k]:0.3f}")
                flp.write("\n")
    if outputlocal:
        flp.close()
    return counts, totlengths, counts2, counts3, nregions


def _write_tables(file_root: str, counts, totlengths, counts2, counts3,
                  nregions, N: int, ploidy: int) -> None:
    """Normalise the chunk lengths a recipient and write the four tables
    (pbwtPaint.c:162-208)."""
    n_inds = len(nregions)
    for i in range(n_inds):
        indsum = totlengths[i].sum()
        if indsum:
            totlengths[i] = totlengths[i] / indsum * N * ploidy

    fc = fopen_tag(file_root, "chunkcounts.out", "w")
    fl = fopen_tag(file_root, "chunklengths.out", "w")
    fc2 = fopen_tag(file_root, "regionsquaredchunkcounts.out", "w")
    fc3 = fopen_tag(file_root, "regionchunkcounts.out", "w")
    fc.write("RECIPIENT")
    fl.write("RECIPIENT")
    fc2.write("RECIPIENT nregions")
    fc3.write("RECIPIENT nregions")
    for i in range(n_inds):
        for f in (fc, fl, fc2, fc3):
            f.write(f" IND{i + 1}")
    for f in (fc, fl, fc2, fc3):
        f.write("\n")
    # all four tables formatted in four C calls
    rows_c, rows_l, rows_2, rows_3 = (
        native.format_f4_rows(t) for t in (counts, totlengths, counts2,
                                           counts3))
    for i in range(n_inds):
        fc3.write(f"IND{i + 1} {nregions[i]:.2f}")
        fc2.write(f"IND{i + 1} {nregions[i]:.2f}")
        fl.write(f"IND{i + 1}")
        fc.write(f"IND{i + 1}")
        fc.write(rows_c[i])
        fl.write(rows_l[i])
        fc2.write(rows_2[i])
        fc3.write(rows_3[i])
        for f in (fc, fl, fc2, fc3):
            f.write("\n")
    for f in (fc, fl, fc2, fc3):
        f.close()


class _GzipStream:
    """A text file written as gzip the way zlib's ``gzopen(path, "w6")``
    writes it (the JAX package's C runtime): a deflate stream at level 6
    in a gzip wrapper of flags 0, mtime 0 and OS 3, so the bytes are the
    same from run to run and equal the JAX package's. Python's
    ``gzip.open`` would put the file name, the time and OS 255 in the
    header."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._z = zlib.compressobj(6, zlib.DEFLATED, 31)

    def write(self, text: str) -> None:
        self._f.write(self._z.compress(text.encode()))

    def close(self) -> None:
        self._f.write(self._z.flush())
        self._f.close()


def paint_ancestry_matrix_sparse(p: PBWT, file_root: str,
                                 chunksperregion: int = 100, ploidy: int = 2,
                                 cutoff: float = 0) -> None:
    """paintAncestryMatrixSparse (pbwtPaint.c:211-328): streams per-individual
    sparse rows to gzipped .s.out.gz files with a match-length cutoff."""
    _check_ploidy(p, ploidy)
    n_inds = p.M // ploidy
    nregions = np.zeros(n_inds)

    fr, fc, fl, fc2, fc3 = (_GzipStream(f"{file_root}.{t}.s.out.gz") for t in (
        "nregions", "chunkcounts", "chunklengths",
        "regionsquaredchunkcounts", "regionchunkcounts"))

    def print_all(ii, t_counts, t_counts2, t_counts3, t_totlengths, nreg):
        nz = np.flatnonzero(t_counts)
        if len(nz):
            i1 = ii + 1
            fc.write("".join(f"{i1} {j + 1} {t_counts[j]:.4f}\n"
                             for j in nz))
            fl.write("".join(f"{i1} {j + 1} {t_totlengths[j]:.4f}\n"
                             for j in nz))
            fc2.write("".join(f"{i1} {j + 1} {t_counts2[j]:.4f}\n"
                              for j in nz))
            fc3.write("".join(f"{i1} {j + 1} {t_counts3[j]:.4f}\n"
                              for j in nz))
        fr.write(f"{ii + 1} {nreg:.2f}\n")

    part_counts = np.zeros(n_inds)
    t_counts = np.zeros(n_inds)
    t_counts2 = np.zeros(n_inds)
    t_counts3 = np.zeros(n_inds)
    t_totlengths = np.zeros(n_inds)

    lib = native.get_lib()
    sj, ss, se, seg_off = _collect_match_arrays(p)
    nreg1 = np.zeros(1)
    ind1 = np.zeros(1)
    for ii in range(n_inds):
        part_counts[:] = 0.0
        t_counts[:] = 0.0
        t_counts2[:] = 0.0
        t_counts3[:] = 0.0
        t_totlengths[:] = 0.0
        nreg1[0] = 0.0
        ind1[0] = 0.0
        lib.paint_sparse_ind(sj, ss, se, seg_off, ii * ploidy,
                             (ii + 1) * ploidy, p.N, n_inds, ploidy,
                             chunksperregion, float(cutoff),
                             t_counts, t_counts2, t_counts3,
                             t_totlengths, nreg1, part_counts, ind1)
        nregions[ii] = nreg1[0]
        nz = t_totlengths != 0
        if ind1[0]:
            t_totlengths[nz] = (t_totlengths[nz] / ind1[0]
                                * p.N * ploidy)
        print_all(ii, t_counts, t_counts2, t_counts3, t_totlengths,
                  nregions[ii])
    for f in (fc, fl, fc2, fc3, fr):
        f.close()
