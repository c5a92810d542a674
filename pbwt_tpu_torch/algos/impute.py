"""Reference imputation: the dosage codec and imputation by weighted
maximal-match voting (pbwtImpute.c).

Counterpart of ``pbwt_tpu/algos/impute.py`` for ``-referenceImpute`` and
``-imputeMissing``: the dosage codec, ``reference_impute3``,
``reference_impute`` and ``impute_missing``. The matches are collected on
the host (the C sweep or, for -imputeMissing, the C within-panel scan; the
callback matchers without the C runtime); the votes are taken by the
streaming C pass on the host, by kernel K5 on the device engine when
:func:`pbwt_tpu_torch.ops.device_requested` says so (not for
-imputeMissing, whose pass is host C in the reference too), or by numpy
without the C runtime. All three give the same bytes: a vote's weights are
integers, so its f64 sums are exact in any order.

Not in the port yet (served by ``python -m pbwt_tpu``): ``-genotypeCompare``
and the corruption utilities.
"""

from __future__ import annotations

import math

import numpy as np

from ..core import engine, native, pack3 as p3, registry
from ..core.pbwt import PBWT
from ..ops import device_requested
from ..utils import log, time_update
from . import match as matchmod

# --------------------------------------------------------------------------
# dosage codec (pbwtImpute.c:1631-1700)
# --------------------------------------------------------------------------

_DOSAGE_VALUE = np.array([0.0, 0.05, 0.15, 0.25, 0.35, 0.45, 0.0, 0.0,
                          1.0, 0.95, 0.85, 0.75, 0.65, 0.55, 1.0, 1.0])


def dosage_encode(d: np.ndarray) -> np.ndarray:
    """Quantise posterior probs to 6 levels relative to the allele value."""
    d = np.asarray(d, dtype=np.float64)
    dd = np.where(d > 0.5, 1.0 - d, d)
    enc = np.where(dd == 0.0, 0, (10.0 * (dd + 0.0999999)).astype(np.int64))
    return enc.astype(np.uint8)


def _dosage_emit(out: bytearray, d: int, count: int) -> None:
    """dosageStore (pbwtImpute.c:1643-1657)."""
    if d == 0:
        while count >= (1 << 15):
            out.append(0xFF)
            count -= 31 << 10
        if count >= (1 << 10):
            out.append((7 << 5) | (count >> 10))
            count &= 1023
        if count >= (1 << 5):
            out.append((6 << 5) | (count >> 5))
            count &= 31
        out.append(count)
    else:
        while count >= (1 << 5):
            out.append((d << 5) | 31)
            count -= 31
        out.append((d << 5) | count)


def dosage_store(p: PBWT, dosage: np.ndarray, k: int,
                 zbuf: bytearray, offsets: list[int]) -> None:
    """pbwtDosageStore: append RLE-coded quantised dosages for site k."""
    while len(offsets) <= k:
        offsets.append(0)
    offsets[k] = len(zbuf)
    enc = dosage_encode(dosage)
    syms, lens = p3._runs(enc)
    for s, n in zip(syms.tolist(), lens.tolist()):
        _dosage_emit(zbuf, int(s), int(n))


def dosage_retrieve(p: PBWT, y: np.ndarray, k: int) -> np.ndarray:
    """pbwtDosageRetrieve: decode site k's dosages (sorted order, needs y)."""
    if p.dosageOffset is None:
        raise ValueError("dosageRetrieve called without p->dosageOffset")
    z = p.zDosage
    off = int(p.dosageOffset[k])
    out = np.empty(p.M, dtype=np.float64)
    i = 0
    while i < p.M:
        b = z[off]
        off += 1
        x = b >> 5
        count = b & 0x1F
        if x == 6:
            count <<= 5
        elif x == 7:
            count <<= 10
        idx = x + (y[i:i + count].astype(np.int64) << 3)
        out[i:i + count] = _DOSAGE_VALUE[idx]
        i += count
    return out


# --------------------------------------------------------------------------
# reference imputation (referenceImpute3, pbwtImpute.c:1126-1261)
# --------------------------------------------------------------------------

def _collect_matches(p_frame: PBWT, p_old: PBWT) -> np.ndarray:
    """The maximal matches of every target haplotype against the frame as
    (n, 4) int64 rows [target, jRef, start, end] in report order: the C
    sweep's, or the callback sweep's without the C runtime."""
    rows = None
    if native.get_lib() is not None:
        rows = matchmod.match_sequences_sweep_rows(p_frame, p_old)
    if rows is None:
        reports: list[tuple[int, int, int, int]] = []
        matchmod.match_sequences_sweep(
            p_frame, p_old, lambda iq, j_ref, start, end:
            reports.append((iq, j_ref, start, end)))
        rows = np.asarray(reports, np.int64).reshape(-1, 4)
    return rows


def _vote_all_sites(segments: np.ndarray, T: int, Xref_nat: np.ndarray,
                    kold_of_kref: np.ndarray, ref_freq: np.ndarray,
                    chunk: int = 512):
    """Vectorised weighted vote over all reference sites (the inner loops of
    referenceImpute3, pbwtImpute.c:1204-1232): per target and site,
    sum w = (kOld-start)*(end-kOld) over covering segments (weights > 0 and
    start < kOld) and the allele-weighted score, via a float64
    cumsum-difference over the per-target segment ranges. segments: (n, 4)
    rows [target, jRef, start, end] sorted by target.

    Returns (x (T, Nref) uint8, dosage (T, Nref) float64, voted bool)."""
    Nref = Xref_nat.shape[1]
    if not len(segments):
        dosage = np.broadcast_to(ref_freq, (T, Nref)).copy()
        return (dosage > 0.5).astype(np.uint8), dosage, np.zeros(
            (T, Nref), bool)
    off = np.zeros(T + 1, np.int64)
    np.cumsum(np.bincount(segments[:, 0], minlength=T), out=off[1:])
    jref = segments[:, 1]
    s0 = segments[:, 2][:, None].astype(np.float64)
    e0 = segments[:, 3][:, None].astype(np.float64)
    x = np.empty((T, Nref), np.uint8)
    dosage = np.empty((T, Nref), np.float64)
    voted = np.empty((T, Nref), bool)
    ns = len(segments)
    w = np.empty((ns, chunk))
    t1 = np.empty((ns, chunk))
    cw = np.zeros((ns + 1, chunk))
    for c0 in range(0, Nref, chunk):
        c1 = min(c0 + chunk, Nref)
        cc = c1 - c0
        k = kold_of_kref[c0:c1][None, :].astype(np.float64)
        wv, tv = w[:, :cc], t1[:, :cc]
        np.subtract(k, s0, out=wv)
        np.subtract(e0, k, out=tv)
        wv *= tv
        wv[~((s0 < k) & (wv > 0))] = 0.0
        np.cumsum(wv, axis=0, out=cw[1:, :cc])
        ssum = cw[off[1:], :cc] - cw[off[:-1], :cc]
        np.multiply(wv, Xref_nat[jref, c0:c1], out=tv)
        np.cumsum(tv, axis=0, out=cw[1:, :cc])
        score = cw[off[1:], :cc] - cw[off[:-1], :cc]
        v = ssum > 0
        with np.errstate(invalid="ignore", divide="ignore"):
            pj = score / ssum
        dj = np.where(v, pj, ref_freq[c0:c1][None, :])
        dosage[:, c0:c1] = dj
        x[:, c0:c1] = dj > 0.5
        voted[:, c0:c1] = v
    return x, dosage, voted


def _within_segments(p_frame: PBWT):
    """The maximal within-panel matches of every haplotype of the frame,
    as imputeMissing's targets (pbwtImpute.c:1143-1159): (jRef, start, end)
    int32 columns, each target's sorted by start (report order among equal
    starts), and the (T+1,) offsets of the targets' runs."""
    T = p_frame.M
    if p_frame.N == 0 and not registry.is_check:
        # every match of an empty frame is the degenerate (0, 0), whose
        # weight is never positive: no segment votes (-check logs counts)
        empty = np.zeros(0, np.int32)
        return empty, empty, empty, np.zeros(T + 1, np.int64)
    a0 = (p_frame.aFstart if p_frame.aFstart is not None
          else np.arange(T, dtype=np.int32))
    if p_frame.yz and native.get_lib() is not None:
        # two passes of the C scan straight into per-target runs, sorted by
        # start in place: the (n, 4) row set is never held
        cols = native.max_within_bucketed(p_frame.yz, T, p_frame.N, a0)
        native.buckets_sort_start(*cols)
        return cols
    reports: list[tuple[int, int, int, int]] = []
    matchmod.match_maximal_within(
        p_frame, lambda ai, bi, s, e: reports.append((ai, bi, s, e)))
    rows = np.asarray(reports, np.int64).reshape(-1, 4)
    rows = rows[np.lexsort((rows[:, 2], rows[:, 0]))]
    seg_off = np.zeros(T + 1, np.int64)
    np.cumsum(np.bincount(rows[:, 0], minlength=T), out=seg_off[1:])
    return (*(np.ascontiguousarray(rows[:, c], np.int32) for c in (1, 2, 3)),
            seg_off)


def _missing_mask(p: PBWT) -> np.ndarray:
    """(M, N) bool: the entries of p marked missing, in natural order (each
    site's pack3 column of the missing stream, offset 0 = none)."""
    miss = np.zeros((p.M, p.N), bool)
    if p.missingOffset is None:
        return miss
    buf = np.frombuffer(p.zMissing, np.uint8)
    for k in np.flatnonzero(p.missingOffset):
        off = int(p.missingOffset[k])
        syms, lens = p3.decode_lengths(buf[off:off + p.M])
        n = int(np.searchsorted(np.cumsum(lens), p.M)) + 1
        miss[:, k] = np.repeat(syms[:n], lens[:n])[:p.M] != 0
    return miss


def _frame_coordinates(p_ref: PBWT, p_frame: PBWT) -> np.ndarray:
    """Frame coordinate per reference site (the kOld the serial loop would
    hold at that site, pbwtImpute.c:1185-1190)."""
    frame_keys = [(s.x, s.varD) for s in p_frame.sites]
    kold_of_kref = np.zeros(p_ref.N, np.int64)
    k_old = 0
    for k_ref, rs in enumerate(p_ref.sites):
        if (k_old < len(frame_keys) and rs.x == frame_keys[k_old][0]
                and rs.varD == frame_keys[k_old][1]):
            k_old += 1
        kold_of_kref[k_ref] = k_old
    return kold_of_kref


def _vote_sums(voted, x_all, dos_all):
    """Per reference site over the targets that voted: (the count, the sum
    of dosages, of alleles, of dosage x allele), for the info scores."""
    return (voted.sum(axis=0), np.where(voted, dos_all, 0.0).sum(axis=0),
            np.where(voted, x_all, 0).sum(axis=0).astype(np.float64),
            np.where(voted, dos_all * x_all, 0.0).sum(axis=0))


def _emit(x_all, dos_all, a):
    """native.impute_emit on the (T, Nref) results made site-major."""
    return native.impute_emit(np.ascontiguousarray(x_all.T),
                              np.ascontiguousarray(dos_all.T), a)


def _set_impute_info(ref_sites, psums, xsums, pxsums, nvote) -> None:
    with np.errstate(invalid="ignore", divide="ignore"):
        psn = psums / nvote
        xsn = xsums / nvote
        pxn = pxsums / nvote
    for k_ref in range(len(ref_sites)):
        if nvote[k_ref]:
            var_prod = (psn[k_ref] * (1 - psn[k_ref])
                        * xsn[k_ref] * (1 - xsn[k_ref]))
            ref_sites[k_ref].imputeInfo = (
                (pxn[k_ref] - psn[k_ref] * psn[k_ref])
                / math.sqrt(var_prod) if var_prod else 1.0)


def reference_impute3(p_old: PBWT, p_ref: PBWT, p_frame: PBWT,
                      n_sparse: int = 1, f_sparse: float = 1.0,
                      device=None) -> PBWT:
    msg = "Reference impute using maximal matches: "
    if n_sparse > 1:   # pbwtImpute.c:1136
        msg += f"(nSparse = {n_sparse}, fSparse = {f_sparse:.2f}) "
    log(msg)
    # self-impute (imputeMissing): the frame is the panel's complete sites,
    # the targets its own haplotypes; complete entries copy straight
    # through and only missing ones vote (pbwtImpute.c:1323-1371)
    self_impute = p_old is p_frame
    lib = native.get_lib()
    T, Nref = p_old.M, p_ref.N
    if self_impute:
        seg_cols, rows = _within_segments(p_frame), None
        cnts = np.diff(seg_cols[3])
    else:
        seg_cols, rows = None, _collect_matches(p_frame, p_old)
        cnts = np.bincount(rows[:, 0], minlength=T)
    if registry.is_check:
        for j in range(T):                              # + the end marker
            log(f"{int(cnts[j]) + 1} matches found to query {j}")

    p_new = PBWT(T, Nref)
    p_new.isRefFreq = True
    ref_sites = p_ref.sites
    kold_of_kref = _frame_coordinates(p_ref, p_frame)
    use_device = not self_impute and device_requested()
    a_ref0 = (p_ref.aFstart if p_ref.aFstart is not None
              else np.arange(p_ref.M, dtype=np.int32))

    if not use_device and lib is not None and p_ref.yz:
        # the whole core as one streaming C pass with O(Mref + T) live
        # memory (the reference's cursor memory model); the segments are
        # sorted by (target, start) in C, as the per-target scans require
        # (the reference qsorts each target's list by start,
        # pbwtImpute.c:1150-1159)
        if seg_cols is None:
            seg_cols = native.segs_sort(rows, T)
        jr_c, s_c, e_c, seg_off = seg_cols
        missing = {}
        if self_impute:
            missing = dict(zmiss=p_ref.zMissing, miss_off=(
                p_ref.missingOffset if p_ref.missingOffset is not None
                else np.zeros(Nref, np.int64)))
        (p_new.yz, p_new.zDosage, dos_off, ref_freq, psums, xsums,
         pxsums, nvote, n_conflicts, a_end) = native.impute_vote_emit(
            p_ref.yz, p_ref.M, Nref, a_ref0, None, seg_off, T,
            kold_of_kref, seg_cols=(jr_c, s_c, e_c), **missing)
        p_new.aFend = a_end
        p_new.dosageOffset = dos_off
    else:
        # materialised paths: the device engine, or no native runtime
        if seg_cols is not None:
            jr_c, s_c, e_c, seg_off = seg_cols
            rows = np.stack([np.repeat(np.arange(T), np.diff(seg_off)), jr_c,
                             s_c, e_c], axis=1).astype(np.int64)
        segments = rows[np.lexsort((rows[:, 2], rows[:, 0]))]
        Xcols = Xref_nat = None
        if lib is not None and p_ref.yz:
            Xcols, _, onec = native.natural_cols(p_ref.yz, Nref, p_ref.M,
                                                 a_ref0)
            ref_freq = onec / float(p_ref.M)
        else:
            Xref_nat = p_ref.haplotypes()
            ref_freq = ((p_ref.decoded(True) != 0).sum(axis=1)
                        / float(p_ref.M)).astype(np.float64)
        if use_device:
            from ..ops import impute as device_impute
            Xref = (device_impute.reference_rows(Xcols, device)
                    if Xcols is not None else Xref_nat)
            x_all, dos_all, voted = device_impute.impute_dosages_device(
                segments, T, Xref, kold_of_kref, ref_freq, device=device)
        else:
            x_all, dos_all, voted = _vote_all_sites(
                segments, T, Xref_nat, kold_of_kref, ref_freq)
        voted = voted.astype(bool, copy=False)
        if self_impute:
            miss = _missing_mask(p_ref)
            x_nat = Xref_nat if Xref_nat is not None else Xcols.T
            n_conflicts = int((miss & ~voted).sum())
            voted = voted & miss
            x_all = np.where(miss, x_all, x_nat).astype(np.uint8)
            dos_all = np.where(miss, dos_all, x_nat.astype(np.float64))
        else:
            n_conflicts = int((~voted).sum())
        nvote, psums, xsums, pxsums = _vote_sums(voted, x_all, dos_all)

        u_new = engine.WriteCursor(T)
        if lib is not None:
            # whole output stage in one C pass (gather + pack3 + dosage
            # RLE + prefix advance per site)
            p_new.yz, p_new.zDosage, dos_off, p_new.aFend = _emit(
                x_all, dos_all, u_new.a)
            p_new.dosageOffset = dos_off
        else:
            zdosage = bytearray()
            dosage_offsets: list[int] = []
            for k_ref in range(Nref):
                y_new = x_all[u_new.a, k_ref]
                dosage_store(p_new, dos_all[u_new.a, k_ref], k_ref, zdosage,
                             dosage_offsets)
                u_new.write_forwards(y_new)
            p_new.set_from_write_cursor(u_new, Nref)
            p_new.zDosage = bytes(zdosage)
            p_new.dosageOffset = np.array(dosage_offsets, dtype=np.int64)
    p_new.N = Nref
    p_new.invalidate()
    for k_ref in range(Nref):
        ref_sites[k_ref].refFreq = float(ref_freq[k_ref])
    _set_impute_info(ref_sites, psums, xsums, pxsums, nvote)
    if n_conflicts:
        log(f"{n_conflicts} times where no overlapping matches because "
            "query does not match any reference - set imputed value to 0")
    return p_new


def reference_impute(p_old: PBWT, root: str, n_sparse: int = 1,
                     f_sparse: float = 1.0, device=None) -> PBWT:
    """referenceImpute (pbwtImpute.c:1265-1319)."""
    from ..io import pbwtfile
    log(f"impute against reference {root}")
    if p_old is None or not p_old.yz or p_old.sites is None:
        raise ValueError("referenceImpute called without existing pbwt with sites")
    p_ref = pbwtfile.read_all(root)
    if p_ref.sites is None:
        raise ValueError(f"new pbwt {root} in referencePhase has no sites")
    if p_old.chrom != p_ref.chrom:
        raise ValueError(f"mismatching chrom in referenceImpute: old "
                         f"{p_ref.chrom}, new {p_old.chrom}")
    p_frame = p_ref.select_sites(p_old.sites, keep_old=True)
    if p_frame.N == p_ref.N:
        log("No additional sites to impute in referenceImpute")
        return p_old
    p_frame.build_reverse()
    p_old = p_old.select_sites_fill_missing(p_ref.sites, keep_old=False)
    if not p_old.N:
        raise ValueError("no overlapping sites in referenceImpute")
    log("Imputation preliminaries: ")
    time_update()
    p_new = reference_impute3(p_old, p_ref, p_frame, n_sparse, f_sparse,
                              device=device)
    p_new.sites = p_ref.sites
    p_new.chrom = p_ref.chrom
    p_new.samples = p_old.samples
    return p_new


def impute_missing(p_old: PBWT) -> PBWT:
    """imputeMissing (pbwtImpute.c:1323-1371): frame = complete-data sites."""
    if p_old.missingOffset is None:
        log("imputeMissing called but can't find missing data")
        return p_old
    complete = [p_old.sites[k] for k in range(p_old.N)
                if not p_old.missingOffset[k]]
    p_frame = p_old.select_sites(complete, keep_old=True)
    p_frame.missingOffset = p_old.missingOffset  # unused for frame matching
    # special mode of impute3: pOld == pFrame, pRef = the original panel
    p_new = reference_impute3(p_frame, p_old, p_frame, 1, 0)
    p_new.sites = p_old.sites
    p_new.samples = p_old.samples
    p_new.chrom = p_old.chrom
    return p_new
