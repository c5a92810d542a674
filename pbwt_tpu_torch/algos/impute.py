"""Imputation: the dosage codec, reference imputation by weighted
maximal-match voting, missing-data imputation, genotype comparison and
the corruption and copy utilities (pbwtImpute.c).

Counterpart of ``pbwt_tpu/algos/impute.py``. ``-referenceImpute``
(``reference_impute3``, ``reference_impute``) on the device engine, when
:func:`pbwt_tpu_torch.ops.device_requested` says so, runs through a
:class:`ReferenceImputer`: the reference standing on the device, the
targets' matches from its frame's ``DeviceMatcher`` and the votes from
kernel K5. On the host the matches come from the C sweep (for
``-imputeMissing``, ``impute_missing``, the C within-panel scan; the
callback matchers without the C runtime) and the votes from the streaming
C pass, or numpy without the C runtime. All give the same bytes: the match
sets are equal, and a vote's weights are
integers, so its f64 sums are exact in any order. ``-genotypeCompare``,
``-corruptSites``, ``-corruptSamples`` and ``-copySamples`` run on the
host C runtime, as in the JAX package; the last three draw from its
glibc rand() stream (:mod:`pbwt_tpu_torch.core.crand`).
"""

from __future__ import annotations

import math
import sys

import numpy as np

from ..core import crand, engine, native, pack3 as p3, registry
from ..core.pbwt import PBWT
from ..ops import device_requested
from ..utils import log, time_update
from . import match as matchmod

F_BOUND = [0.1, 0.2, 0.3, 0.5, 0.7, 1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 90, 100.01]

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


def _impute_info(psums, xsums, pxsums, nvote) -> np.ndarray:
    """Each reference site's info score (pbwtImpute.c:1250-1259), NaN where
    no target voted: the score stays what the site held."""
    with np.errstate(invalid="ignore", divide="ignore"):
        psn, xsn, pxn = psums / nvote, xsums / nvote, pxsums / nvote
        var_prod = psn * (1 - psn) * xsn * (1 - xsn)
        info = np.where(var_prod != 0, (pxn - psn * psn) / np.sqrt(var_prod),
                        1.0)
    return np.where(nvote > 0, info, np.nan)


def _set_impute_info(ref_sites, psums, xsums, pxsums, nvote) -> None:
    info = _impute_info(psums, xsums, pxsums, nvote)
    for k_ref in np.flatnonzero(nvote).tolist():
        ref_sites[k_ref].imputeInfo = float(info[k_ref])


def _emit_pbwt(p_new: PBWT, x_all, dos_all) -> None:
    """The output stage: p_new's pack3 alleles, dosages and final prefix
    array from the (T, Nref) results, in one C pass (gather + pack3 + dosage
    RLE + prefix advance per site), or a site at a time without the C
    runtime."""
    T, Nref = x_all.shape
    u_new = engine.WriteCursor(T)
    if native.get_lib() is not None:
        p_new.yz, p_new.zDosage, p_new.dosageOffset, p_new.aFend = _emit(
            x_all, dos_all, u_new.a)
        return
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


def _log_conflicts(n_conflicts: int) -> None:
    if n_conflicts:
        log(f"{n_conflicts} times where no overlapping matches because "
            "query does not match any reference - set imputed value to 0")


def _reference_columns(p_ref: PBWT):
    """(Xcols (Nref, Mref) site-major natural-order alleles, None) with the
    C runtime, else (None, Xref (Mref, Nref)); and ref_freq, each site's
    share of 1 alleles in f64."""
    a0 = (p_ref.aFstart if p_ref.aFstart is not None
          else np.arange(p_ref.M, dtype=np.int32))
    if native.get_lib() is not None and p_ref.yz:
        Xcols, _, onec = native.natural_cols(p_ref.yz, p_ref.N, p_ref.M, a0)
        return Xcols, None, onec / float(p_ref.M)
    return (None, p_ref.haplotypes(),
            ((p_ref.decoded(True) != 0).sum(axis=1)
             / float(p_ref.M)).astype(np.float64))


class ReferenceImputer:
    """Reference imputation (referenceImpute3, pbwtImpute.c:1126-1261)
    against a panel held standing on ``device``.

    Set-up (the span ``setup.imputer``) decodes the reference once and keeps
    its donor rows on the device in K5's layout with each site's allele
    share (``.rows``), each reference site's frame coordinate (``.frame``)
    and the frame's standing matcher (``.matcher``: ``DeviceMatcher`` of
    ``p_frame``, the reference at the typed sites, where it has more than
    ``DEVICE_MIN_M`` haplotypes; a smaller frame is matched by the host's C
    sweep). :meth:`impute` then takes a batch of targets typed at the frame's
    sites: their set-maximal matches against the frame, kernel K5's vote at
    every reference site, and the host's output pass. The result owns its
    sites, so a later call leaves an earlier result as it was; the imputer
    changes neither ``p_ref`` nor ``p_frame``.
    """

    def __init__(self, p_ref: PBWT, p_frame: PBWT, device=None):
        import torch

        from .. import tracing
        from ..ops import impute as vote, resolve_device
        self.ref, self.frame = p_ref, p_frame
        self.device = dev = resolve_device(device)
        with tracing.span("setup.imputer"):
            with tracing.span("setup.imputer.rows"):
                Xcols, Xref, self.ref_freq = _reference_columns(p_ref)
                self.rows = (vote.reference_rows(Xcols, dev) if Xref is None
                             else vote.pitched_rows(torch.from_numpy(Xref)
                                                    .to(dev)))
                self.freq = torch.from_numpy(self.ref_freq).to(dev)
                del Xcols, Xref
            with tracing.span("setup.imputer.frame"):
                self.kold = torch.from_numpy(_frame_coordinates(
                    p_ref, p_frame).astype(np.int32)).to(dev)
            with tracing.span("setup.imputer.matcher"):
                self.matcher = (matchmod._matcher(p_frame, dev)
                                if p_frame.M > matchmod.DEVICE_MIN_M
                                else None)

    def _matches(self, p_old: PBWT) -> np.ndarray:
        """(n, 4) rows (target, donor, start, end) of every set-maximal
        match of the targets against the frame: the standing matcher's, or
        the host sweep's for a small frame. They are the same set; the vote
        sums integer weights, exact in any order, so theirs does not
        matter."""
        from .. import tracing
        if self.matcher is None:
            with tracing.span("ops.impute.match"):
                return _collect_matches(self.frame, p_old)
        with tracing.span("ops.impute.targets"):
            Xq = p_old.haplotypes()
        with tracing.span("ops.impute.match"):
            rows = self.matcher.match(Xq)
        matchmod.log_best_matches(rows, p_old.M, p_old.N)
        return rows

    def impute(self, p_old: PBWT) -> PBWT:
        """The imputed panel of the targets ``p_old`` (a PBWT of the frame's
        sites): alleles, dosages and the final prefix array at every
        reference site, the reference's sites (copies) with each one's
        refFreq and info score, its chromosome, the targets' samples."""
        import torch

        from .. import tracing
        from ..ops import impute as vote
        if p_old.N != self.frame.N:
            raise ValueError(f"{p_old.N} target sites against a frame of "
                             f"{self.frame.N}")
        T, Nref, dev = p_old.M, self.ref.N, self.device
        with tracing.span("ops.impute"):
            rows = self._matches(p_old)
            if registry.is_check:
                cnts = np.bincount(rows[:, 0], minlength=T)
                for j in range(T):                      # + the end marker
                    log(f"{int(cnts[j]) + 1} matches found to query {j}")
            with tracing.span("ops.impute.segments"):
                off, jref, s, e = (torch.from_numpy(c).to(dev) for c in
                                   vote.segment_columns(rows, T))
            with tracing.span("ops.impute.vote"):
                out = vote.impute_vote(off, jref, s, e, self.rows, self.kold,
                                       self.freq)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            with tracing.span("ops.impute.download"):
                x_all, dos_all, voted = vote.download(*out)
                del out
            with tracing.span("ops.impute.sums"):
                n_conflicts = int(T * Nref - np.count_nonzero(voted))
                nvote, psums, xsums, pxsums = _vote_sums(voted, x_all,
                                                         dos_all)
                info = _impute_info(psums, xsums, pxsums, nvote)
                sites = [site.copy() for site in self.ref.sites]
                for site, f, i in zip(sites, self.ref_freq.tolist(),
                                      info.tolist()):
                    site.refFreq = f
                    if i == i:                          # not NaN: voted
                        site.imputeInfo = i
            p_new = PBWT(T, Nref)
            p_new.isRefFreq = True
            with tracing.span("ops.impute.emit"):
                _emit_pbwt(p_new, x_all, dos_all)
            p_new.invalidate()
            p_new.sites, p_new.chrom = sites, self.ref.chrom
            p_new.samples = p_old.samples
        tracing.count("ops.impute.targets", T)
        tracing.count("ops.impute.segments", len(rows))
        tracing.count("ops.impute.ref_sites", Nref)
        tracing.count("ops.impute.genotypes", T * Nref)
        _log_conflicts(n_conflicts)
        return p_new


def reference_impute3(p_old: PBWT, p_ref: PBWT, p_frame: PBWT,
                      n_sparse: int = 1, f_sparse: float = 1.0,
                      device=None) -> PBWT:
    """referenceImpute3 (pbwtImpute.c:1126-1261): the imputed PBWT, each
    reference site's refFreq and info score set on p_ref's sites. On the
    device route a :class:`ReferenceImputer` made for this call."""
    msg = "Reference impute using maximal matches: "
    if n_sparse > 1:   # pbwtImpute.c:1136
        msg += f"(nSparse = {n_sparse}, fSparse = {f_sparse:.2f}) "
    log(msg)
    # self-impute (imputeMissing): the frame is the panel's complete sites,
    # the targets its own haplotypes; complete entries copy straight
    # through and only missing ones vote (pbwtImpute.c:1323-1371)
    self_impute = p_old is p_frame
    if not self_impute and device_requested():
        p_new = ReferenceImputer(p_ref, p_frame, device).impute(p_old)
        for site, got in zip(p_ref.sites, p_new.sites):
            site.refFreq, site.imputeInfo = got.refFreq, got.imputeInfo
        return p_new
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
    a_ref0 = (p_ref.aFstart if p_ref.aFstart is not None
              else np.arange(p_ref.M, dtype=np.int32))

    if lib is not None and p_ref.yz:
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
        # without the C runtime: the segments and the panel materialised,
        # the vote in numpy
        if seg_cols is not None:
            jr_c, s_c, e_c, seg_off = seg_cols
            rows = np.stack([np.repeat(np.arange(T), np.diff(seg_off)), jr_c,
                             s_c, e_c], axis=1).astype(np.int64)
        segments = rows[np.lexsort((rows[:, 2], rows[:, 0]))]
        _, Xref_nat, ref_freq = _reference_columns(p_ref)
        x_all, dos_all, voted = _vote_all_sites(
            segments, T, Xref_nat, kold_of_kref, ref_freq)
        if self_impute:
            miss = _missing_mask(p_ref)
            n_conflicts = int((miss & ~voted).sum())
            voted = voted & miss
            x_all = np.where(miss, x_all, Xref_nat).astype(np.uint8)
            dos_all = np.where(miss, dos_all, Xref_nat.astype(np.float64))
        else:
            n_conflicts = int((~voted).sum())
        nvote, psums, xsums, pxsums = _vote_sums(voted, x_all, dos_all)
        _emit_pbwt(p_new, x_all, dos_all)
    p_new.N = Nref
    p_new.invalidate()
    for k_ref in range(Nref):
        ref_sites[k_ref].refFreq = float(ref_freq[k_ref])
    _set_impute_info(ref_sites, psums, xsums, pxsums, nvote)
    _log_conflicts(n_conflicts)
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


# --------------------------------------------------------------------------
# genotype comparison (genotypeCompare, pbwtImpute.c:1375-1488)
# --------------------------------------------------------------------------

def genotype_compare(p: PBWT, root: str) -> None:
    from ..io import pbwtfile
    log(f"compare genotypes to reference {root}")
    if p is None or not p.yz or p.sites is None:
        raise ValueError("genotypeCompare called without existing pbwt with sites")
    p_ref = pbwtfile.read_all(root)
    if p.chrom != p_ref.chrom:
        raise ValueError(f"mismatch chrom {p.chrom} to ref {p_ref.chrom}")
    if p_ref.sites is None:
        raise ValueError(f"new pbwt {root} in genotypeCompare has no sites")
    if p.M != p_ref.M:
        raise ValueError(f"mismatch of old M {p.M} to ref M {p_ref.M}")
    if p.N == p_ref.N:
        _genotype_compare_pbwt(p, p_ref)
    else:
        log(f"mismatch of old N {p.N} to ref N {p_ref.N}")
        p_frame = p.select_sites(p_ref.sites, keep_old=True)
        p_ref = p_ref.select_sites(p.sites, keep_old=False)
        if not p_frame.N:
            raise ValueError("no overlapping sites in genotypeCompare")
        _genotype_compare_pbwt(p_frame, p_ref)


def _genotype_compare_pbwt(p: PBWT, q: PBWT) -> None:
    out = sys.stdout
    is_dosage = p.dosageOffset is not None
    nd = np.zeros(12, dtype=np.int64)
    nd1 = np.zeros(12, dtype=np.int64)

    # vectorised accumulation streamed in site chunks (the per-site
    # counting loops of pbwtImpute.c:1398-1438 become bincounts over
    # (bin, genotype-pair) keys; O(M * chunk) live bytes — the dense
    # (M, N) matrices cost more in page faults than the counting at
    # 16k x 16k).  Only the dosage tallies still walk sites, to stream
    # the RLE.
    from ..core import native
    M, N = p.M, p.N
    rf = np.array([s.refFreq for s in p.sites], dtype=np.float64)
    is_ref_freq = bool((rf != 0.0).any())
    ii = np.array([s.imputeInfo for s in p.sites], dtype=np.float64)
    fbound = np.asarray(F_BOUND)

    chunk = 1024
    stream = native.get_lib() is not None and bool(p.yz) and bool(q.yz)
    if stream and not is_dosage:
        # the whole counting pass in C at the reference's own loop cost
        ap0 = (p.aFstart if p.aFstart is not None
               else np.arange(M, dtype=np.int32))
        aq0 = (q.aFstart if q.aFstart is not None
               else np.arange(M, dtype=np.int32))
        res = native.gtcompare_core(p.yz, q.yz, M, N, ap0, aq0, rf, ii,
                                    fbound)
        if res is not None:
            n, ns9c, fsum, nsum, isum, ni = res
            ns = np.zeros((p.M, 9), dtype=np.int64)
            ns[0::2] = ns9c
            _genotype_compare_report(p, is_ref_freq, is_dosage, n, ns,
                                     fsum, nsum, isum, ni, nd, nd1)
            return
    Xp_d = None if stream else p.haplotypes()
    Xq_d = None if stream else q.haplotypes()
    ap = (p.aFstart if p.aFstart is not None
          else np.arange(M, dtype=np.int32))
    aq = (q.aFstart if q.aFstart is not None
          else np.arange(M, dtype=np.int32))
    posp = posq = 0
    n = np.zeros(17 * 9, dtype=np.int64)
    ns9 = np.zeros((9, M // 2), dtype=np.int64)
    fsum = np.zeros(17)
    nsum = np.zeros(17, np.int64)
    isum = np.zeros(17)
    ni = np.zeros(17, np.int64)
    Xp_cols = [] if is_dosage else None
    for k0 in range(0, N, chunk):
        nc = min(chunk, N - k0)
        if stream:
            Xpc, ap, onesc, posp = native.natural_cols(p.yz, nc, M, ap,
                                                       start=posp,
                                                       with_pos=True)
            Xqc, aq, _, posq = native.natural_cols(q.yz, nc, M, aq,
                                                   start=posq,
                                                   with_pos=True)
        else:
            Xpc = np.ascontiguousarray(Xp_d[:, k0:k0 + nc].T)
            Xqc = np.ascontiguousarray(Xq_d[:, k0:k0 + nc].T)
            onesc = Xpc.sum(axis=1, dtype=np.int64)
        f_arr = np.where(rf[k0:k0 + nc] != 0.0, rf[k0:k0 + nc],
                         onesc / float(M))
        # first ff with f*100 <= F_BOUND[ff] == the reference's walk
        ff = np.searchsorted(fbound, f_arr * 100.0, side="left")
        fsum += np.bincount(ff, weights=f_arr * 100.0, minlength=17)
        nsum += np.bincount(ff, minlength=17)
        im = ii[k0:k0 + nc] < 1.0
        isum += np.bincount(ff[im], weights=ii[k0:k0 + nc][im],
                            minlength=17)
        ni += np.bincount(ff[im], minlength=17)
        i9 = 3 * (Xpc[:, 0::2] + Xpc[:, 1::2]) \
            + (Xqc[:, 0::2] + Xqc[:, 1::2])           # (nc, M/2) uint8
        key = ff.astype(np.uint8)[:, None] * 9 + i9   # ff*9+i9 <= 152
        n += np.bincount(key.ravel(), minlength=17 * 9)
        for v in range(9):
            ns9[v] += (i9 == v).sum(axis=0)
        if is_dosage:
            Xp_cols.append(Xpc.copy())
    n = n.reshape(17, 9)
    ns = np.zeros((p.M, 9), dtype=np.int64)
    ns[0::2] = ns9.T

    if is_dosage:
        Xp_nat = np.concatenate(Xp_cols)              # (N, M) site-major
        Yp = p.decoded(True)
        a = p.aFstart.copy()
        for k in range(p.N):
            dos = dosage_retrieve(p, Yp[k], k)
            dos_nat = np.empty(p.M)
            dos_nat[a] = dos
            ids = np.where(dos_nat == 0.0, 0,
                           np.where(dos_nat == 1.0, 11,
                                    1 + (dos_nat * 10.0).astype(np.int64)))
            np.add.at(nd, ids, 1)
            np.add.at(nd1, ids[Xp_nat[k] == 1], 1)
            a = engine.forwards_a(a, Yp[k])

    _genotype_compare_report(p, is_ref_freq, is_dosage, n, ns, fsum,
                             nsum, isum, ni, nd, nd1)


def _genotype_compare_report(p, is_ref_freq, is_dosage, n, ns, fsum,
                             nsum, isum, ni, nd, nd1) -> None:
    """The r2 tables + per-sample accuracy distribution + dosage table
    (pbwtImpute.c:1441-1487)."""
    out = sys.stdout
    if is_ref_freq:
        out.write("Genotype comparison results split on reference frequencies\n")
    else:
        out.write("Genotype comparison results split on sample frequencies\n")
    for ff in range(17):
        row = n[ff]
        tot = row.sum()
        out.write(f"{F_BOUND[ff]:<5.1f}\t"
                  f"{(fsum[ff] / nsum[ff]) if nsum[ff] else 0.0:<7.3f}")
        for i in range(9):
            out.write(f"\t{row[i]} ")
        if tot:
            xbar = (row[3] + row[4] + row[5] + 2 * (row[6] + row[7] + row[8])) / tot
            x2 = (row[3] + row[4] + row[5] + 4 * (row[6] + row[7] + row[8])) / tot
            ybar = (row[1] + row[4] + row[7] + 2 * (row[2] + row[5] + row[8])) / tot
            y2 = (row[1] + row[4] + row[7] + 4 * (row[2] + row[5] + row[8])) / tot
            from ..utils import c_f
            r2 = (row[4] + 2 * (row[5] + row[7]) + 4 * row[8]) / tot
            denom = math.sqrt((x2 - xbar * xbar) * (y2 - ybar * ybar))
            r2 = (r2 - xbar * ybar) / denom if denom else float("nan")
            out.write(f"\tx,y,r2\t{xbar:.4f}\t{ybar:.4f}\t{c_f(r2)}")
            if ni[ff]:
                out.write(f"\t info {isum[ff] / ni[ff]:.4f}")
        out.write("\n")

    hist = np.zeros(101, dtype=np.int64)
    for j in range(0, p.M, 2):
        row = ns[j]
        tot = row.sum()
        if tot:
            xbar = (row[3] + row[4] + row[5] + 2 * (row[6] + row[7] + row[8])) / tot
            x2 = (row[3] + row[4] + row[5] + 4 * (row[6] + row[7] + row[8])) / tot
            ybar = (row[1] + row[4] + row[7] + 2 * (row[2] + row[5] + row[8])) / tot
            y2 = (row[1] + row[4] + row[7] + 4 * (row[2] + row[5] + row[8])) / tot
            r2 = (row[4] + 2 * (row[5] + row[7]) + 4 * row[8]) / tot
            denom = math.sqrt((x2 - xbar * xbar) * (y2 - ybar * ybar))
            r2 = (r2 - xbar * ybar) / denom if denom else 0.0
            if r2 < 0:
                r2 = 0
            hist[int(100 * r2)] += 1
    out.write("Genotype accuracy distribution across samples\n")
    if hist[100]:
        out.write(f"{hist[100]} samples with r2 == 1.0\n")
    for i in range(99, -1, -1):
        if hist[i]:
            out.write(f"{hist[i]} samples with {(i - 1) * 0.01:.2f} <= r2 < "
                      f"{i * 0.01:.2f}\n")
    if is_dosage:
        out.write("Dosage accuracy (currently at haplotype level)\n")
        out.write(f"0.00  {nd1[0] / nd[0] if nd[0] else 0.0:.3f}  {nd[0]}\n")
        for i in range(1, 11):
            out.write(f"{0.1 * (i - 0.5):.2f}  "
                      f"{nd1[i] / nd[i] if nd[i] else 0.0:.3f}  {nd[i]}\n")
        out.write(f"1.00  {nd1[11] / nd[11] if nd[11] else 0.0:.3f}  {nd[11]}\n")


# --------------------------------------------------------------------------
# data corruption / simulation (pbwtImpute.c:1492-1619)
# --------------------------------------------------------------------------

def _corrupt_finish(p_new: PBWT, p_old: PBWT, u_new: engine.WriteCursor) -> PBWT:
    """Adopt sites/chrom/samples from pOld exactly as the reference transfers
    them (pbwtImpute.c:1530-1533)."""
    p_new.yz = u_new.packed()
    p_new.aFend = u_new.a.copy()
    p_new.sites = p_old.sites
    p_new.chrom = p_old.chrom
    return p_new


def corrupt_sites(p_old: PBWT, p_site: float, p_change: float) -> PBWT:
    """pbwtCorruptSites (pbwtImpute.c:1492-1537).

    Bit-reproducible vs the reference binary: draws come from the glibc
    rand() stream (unseeded == srand(1)) and corruption is applied at
    positions in the NEW cursor's sort order, exactly as the reference's
    ``uNew->y[i]`` loop does.
    """
    if not p_old.yz:
        raise ValueError("corruptSites without an existing pbwt")
    if not (0 < p_site <= 1) or not (0 < p_change <= 1):
        raise ValueError(f"pSite {p_site}, pChange {p_change} out of range")
    M, N = p_old.M, p_old.N
    rnd = crand.rand
    r_site = int(p_site * crand.RAND_MAX)
    r_change = int(p_change * crand.RAND_MAX)
    r_fac = crand.RAND_MAX / M
    a0 = (p_old.aFstart if p_old.aFstart is not None
          else np.arange(M, dtype=np.int32))
    res = native.corrupt_sites_core(p_old.yz, M, N, a0,
                                    r_site, r_change, r_fac)
    if res is not None:
        p_new = PBWT(M, N)
        p_new.yz, p_new.aFend, n_change = res
        p_new.sites = p_old.sites
        p_new.chrom = p_old.chrom
        p_new.samples = p_old.samples
        log(f"corruptSites with pSite {p_site:f}, pChange {p_change:f} "
            f"changes {n_change / (N * M):.4f} of values")
        return p_new
    u_old = engine.ReadCursor.create(p_old, True, True)
    u_new = engine.WriteCursor(M)
    n_change = 0
    for k in range(N):
        x = u_old.x_natural()
        y = x[u_new.a]
        if rnd() < r_site:
            thresh = u_old.c * r_fac
            for i in range(M):
                if rnd() < r_change:
                    old = y[i]
                    y[i] = 0 if rnd() < thresh else 1
                    if y[i] != old:
                        n_change += 1
        u_new.write_forwards(y)
        u_old.forwards_read()
    p_new = _corrupt_finish(PBWT(M, N), p_old, u_new)
    p_new.samples = p_old.samples
    log(f"corruptSites with pSite {p_site:f}, pChange {p_change:f} changes "
        f"{n_change / (N * M):.4f} of values")
    return p_new


def corrupt_samples(p_old: PBWT, p_sample: float, p_change: float) -> PBWT:
    """pbwtCorruptSamples (pbwtImpute.c:1539-1584).  Note the reference's
    isCorrupt[] is indexed by position in the new cursor's sort order, not
    by haplotype id — reproduced as-is for bit parity."""
    if not p_old.yz:
        raise ValueError("corruptSites without an existing pbwt")
    if not (0 < p_sample <= 1) or not (0 < p_change <= 1):
        raise ValueError(f"pSample {p_sample}, pChange {p_change} out of range")
    M, N = p_old.M, p_old.N
    rnd = crand.rand
    r_sample = int(p_sample * crand.RAND_MAX)
    r_change = int(p_change * crand.RAND_MAX)
    r_fac = crand.RAND_MAX / M
    a0 = (p_old.aFstart if p_old.aFstart is not None
          else np.arange(M, dtype=np.int32))
    res = native.corrupt_samples_core(p_old.yz, M, N, a0,
                                      r_sample, r_change, r_fac)
    if res is not None:
        p_new = PBWT(M, N)
        p_new.yz, p_new.aFend, n_change = res
        p_new.sites = p_old.sites
        p_new.chrom = p_old.chrom
        p_new.samples = p_old.samples
        log(f"corruptSamples with pSample {p_sample:f}, pChange "
            f"{p_change:f} changes {n_change / (N * M):.4f} of values")
        return p_new
    u_old = engine.ReadCursor.create(p_old, True, True)
    u_new = engine.WriteCursor(M)
    is_corrupt = [rnd() < r_sample for _ in range(M)]
    n_change = 0
    for k in range(N):
        x = u_old.x_natural()
        y = x[u_new.a]
        thresh = u_old.c * r_fac
        for i in range(M):
            if is_corrupt[i] and rnd() < r_change:
                v = 0 if rnd() < thresh else 1
                if v != y[i]:
                    n_change += 1
                y[i] = v
        u_new.write_forwards(y)
        u_old.forwards_read()
    p_new = _corrupt_finish(PBWT(M, N), p_old, u_new)
    p_new.samples = p_old.samples
    log(f"corruptSamples with pSample {p_sample:f}, pChange {p_change:f} changes "
        f"{n_change / (N * M):.4f} of values")
    return p_new


def copy_samples(p_old: PBWT, m_new: int, mean_length: float) -> PBWT:
    """Li-Stephens mosaic simulator (pbwtCopySamples, pbwtImpute.c:1586-1619).

    The reference switches copy[j] indexed by sort-order position j but reads
    through copy[uNew->a[j]] (natural id) — an inconsistency we reproduce for
    bit parity.  The reference also moves the old samples array across even
    though its length no longer matches Mnew; reproduced as-is."""
    if not p_old.yz:
        raise ValueError("copySamples called without an existing pbwt")
    if mean_length < 1.0:
        raise ValueError(f"meanLength {mean_length} must be > 1 in pbwtCopySamples")
    M_old, N = p_old.M, p_old.N
    rnd = crand.rand
    r_switch = int(crand.RAND_MAX / mean_length)
    a0 = (p_old.aFstart if p_old.aFstart is not None
          else np.arange(M_old, dtype=np.int32))
    res = native.copy_samples_core(p_old.yz, M_old, N, a0, m_new, r_switch)
    if res is not None:
        p_new = PBWT(m_new, N)
        p_new.yz, p_new.aFend, _ = res
        p_new.sites = p_old.sites
        p_new.chrom = p_old.chrom
        p_new.samples = p_old.samples
        log(f"copySamples made {m_new} samples with mean switch length "
            f"{mean_length:.1f}")
        return p_new
    u_old = engine.ReadCursor.create(p_old, True, True)
    u_new = engine.WriteCursor(m_new)
    copy = np.array([rnd() % M_old for _ in range(m_new)], dtype=np.int64)
    y = np.empty(m_new, dtype=np.uint8)
    for k in range(N):
        x_old = u_old.x_natural()
        for j in range(m_new):
            if rnd() < r_switch:
                copy[j] = rnd() % M_old
        y[:] = x_old[copy[u_new.a]]
        u_new.write_forwards(y)
        u_old.forwards_read()
    p_new = _corrupt_finish(PBWT(m_new, N), p_old, u_new)
    p_new.samples = p_old.samples
    log(f"copySamples made {m_new} samples with mean switch length {mean_length:.1f}")
    return p_new
