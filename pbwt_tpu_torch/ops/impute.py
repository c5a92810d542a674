"""Reference imputation's weighted vote on the device (kernel K5).

Counterpart of ``pbwt_tpu/ops/impute_jax.py``. Per target haplotype and
reference site, the maximal-match segments that cover the site vote with the
weights w = (k - start)(end - k), k the site's frame coordinate
(referenceImpute3, pbwtImpute.c:1204-1232). The JAX pass takes each target's
sums as an f32 cumulative-sum difference over (nseg, chunk) arrays; here
kernel ``k5_impute_vote`` sums each (target, site)'s own covering segments in
f64, in segment order, so the dosages are the host C pass's to the bit: the
weights are integers and the sums exact below 2^53. A block of the kernel
takes a target and a span of chunks of sites and carries the run of segments
that can weigh from chunk to chunk; a pre-pass of the same launch finds where
each (target, span) starts (:func:`vote_window` is its plain twin).
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, resolve_device
from .partition import _cummax

TWIN_ELEMENTS = 1 << 24     # (segment, site) pairs a step of the plain twin
CHUNK, SPAN_MAX = kernels.K5_LAYOUT   # sites a chunk, most chunks a span
# the slab of donor alleles that the blocks running at one time read, Mref x
# span x CHUNK bytes, is kept this far under the card's 50 MB L2
SPAN_L2_BYTES = 40 << 20
_LIFT = 1 << 31             # int32 values shifted to be non-negative


def impute_vote_plain(seg_off, seg_jref, seg_s, seg_e, Xref, kold, ref_freq):
    """Plain twin of :func:`impute_vote`: a chunk of sites at a time, every
    segment's weight at every site of the chunk, summed a target with
    ``index_add_`` (f64 sums of integers: exact in any order)."""
    T, (Mref, Nref) = seg_off.numel() - 1, Xref.shape
    dev = Xref.device
    nseg = seg_jref.numel()
    target = torch.repeat_interleave(torch.arange(T, device=dev),
                                     seg_off[1:] - seg_off[:-1],
                                     output_size=nseg)
    s = seg_s.double()[:, None]
    e = seg_e.double()[:, None]
    jref = seg_jref.long()
    dosage = torch.empty((T, Nref), dtype=torch.float64, device=dev)
    voted = torch.empty((T, Nref), dtype=torch.uint8, device=dev)
    chunk = min(max(TWIN_ELEMENTS // max(nseg, 1), 1), 512)
    for c0 in range(0, Nref, chunk):
        ko = kold[c0:c0 + chunk].double()[None, :]
        w = (ko - s) * (e - ko)
        w = torch.where((s < ko) & (w > 0), w, torch.zeros_like(w))
        ssum = torch.zeros((T, ko.shape[1]), dtype=torch.float64, device=dev)
        score = torch.zeros_like(ssum)
        ssum.index_add_(0, target, w)
        score.index_add_(0, target, w * Xref[jref, c0:c0 + chunk])
        v = ssum > 0
        dosage[:, c0:c0 + chunk] = torch.where(
            v, score / ssum, ref_freq[None, c0:c0 + chunk])
        voted[:, c0:c0 + chunk] = v
    return dosage, (dosage > 0.5).to(torch.uint8), voted


def span_chunks(mref: int) -> int:
    """Chunks of CHUNK sites a block of K5 walks: as many as keep the slab
    of Xref that the blocks running together read, mref x span x CHUNK
    bytes, within SPAN_L2_BYTES; 1 to SPAN_MAX."""
    return max(1, min(SPAN_MAX, SPAN_L2_BYTES // (max(mref, 1) * CHUNK)))


def vote_window(seg_off, seg_e, kold, span):
    """Where each block of K5 starts its run of segments: the plain twin of
    the kernel's pre-pass (k5_bounds, k5_window).

    Returns (emax (nseg,) int32: each segment's running maximum of ends
    within its target; first (nspans, T) int64: for span p (sites
    [p * span * CHUNK, (p + 1) * span * CHUNK) of kold) and target t, the
    first of t's segments whose emax exceeds the span's least frame
    coordinate, or seg_off[t + 1] where none does). The segments before it
    end at or before every site of the span and weigh nowhere there. One
    binary search over the targets' running maxima, lifted apart by target
    so that they form one sorted array.
    """
    dev = seg_e.device
    T, nseg, Nref = seg_off.numel() - 1, seg_e.numel(), kold.numel()
    rank = torch.arange(T, device=dev) << 32
    lifted = torch.repeat_interleave(rank, seg_off[1:] - seg_off[:-1],
                                     output_size=nseg) + seg_e + _LIFT
    top = _cummax(lifted)
    emax = (top & 0xFFFFFFFF).sub_(_LIFT).to(torch.int32)
    sites = span * CHUNK
    nspans = -(-Nref // sites)
    least = torch.full((nspans * sites,), torch.iinfo(torch.int32).max,
                       dtype=torch.long, device=dev)
    least[:Nref] = kold
    least = least.view(nspans, sites).amin(1)
    first = torch.searchsorted(top, (rank[None, :] + (least + _LIFT)[:, None])
                               .view(-1), right=True)
    return emax, first.view(nspans, T)


def window_buffers(seg_e, T, Nref, span):
    """(emax, first, bounds): what K5's pre-pass writes, allocated; bounds
    holds each span's least frame coordinate, then each chunk's least and
    largest."""
    nchunks = -(-Nref // CHUNK)
    nspans = -(-nchunks // span)
    dev = seg_e.device
    return (torch.empty_like(seg_e),
            torch.empty((nspans, T), dtype=torch.int64, device=dev),
            torch.empty(nspans + 2 * nchunks, dtype=torch.int32, device=dev))


def k5_arguments(dev, seg_off, seg_jref, seg_s, seg_e, Xref, kold, ref_freq,
                 span, window, out):
    """The arguments of the C entry k5_impute_vote, in its order: Xref as
    :func:`pitched_rows` lays it out, window = :func:`window_buffers`, out =
    (dosage, x, voted)."""
    return (dev.index, seg_off.data_ptr(), seg_jref.data_ptr(),
            seg_s.data_ptr(), seg_e.data_ptr(), seg_off.numel() - 1,
            Xref.data_ptr(), Xref.shape[1], Xref.stride(0), kold.data_ptr(),
            ref_freq.data_ptr(), span, *(w.data_ptr() for w in window),
            *(o.data_ptr() for o in out), kernels.stream(dev))


def impute_vote(seg_off, seg_jref, seg_s, seg_e, Xref, kold, ref_freq):
    """The weighted vote of every target at every reference site (kernel
    K5).

    seg_off (T+1,) int64: the range of each target's segments; seg_jref,
    seg_s, seg_e (nseg,) int32: donor, start and end (frame coordinates),
    sorted by (target, start); Xref (Mref, Nref) uint8 donor alleles in
    natural order; kold (Nref,) int32 frame coordinate of each reference
    site; ref_freq (Nref,) float64. Returns (dosage (T, Nref) float64: the
    allele-weighted share of sum w over the segments with start < kold and
    w = (kold - start)(end - kold) > 0, or ref_freq where there is none;
    x uint8 = dosage > 0.5; voted uint8: some segment weighed).
    """
    if Xref.device.type == "cpu":
        return impute_vote_plain(seg_off, seg_jref, seg_s, seg_e, Xref, kold,
                                 ref_freq)
    i32, u8, f64 = torch.int32, torch.uint8, torch.float64
    dev = kernels.typed_cuda_tensors(
        (seg_off, torch.int64), (seg_jref, i32), (seg_s, i32), (seg_e, i32),
        (kold, i32), (ref_freq, f64))
    if Xref.device != dev or Xref.dtype != u8 or Xref.dim() != 2:
        raise ValueError(f"impute_vote: Xref must be a 2-D uint8 tensor on "
                         f"{dev}, got {Xref.dtype} on {Xref.device}")
    T, (Mref, Nref) = seg_off.numel() - 1, Xref.shape
    nseg = seg_jref.numel()
    if (seg_s.numel() != nseg or seg_e.numel() != nseg
            or kold.numel() != Nref or ref_freq.numel() != Nref or T < 0):
        raise ValueError("impute_vote: inconsistent shapes")
    out = tuple(torch.empty((T, Nref), dtype=dt, device=dev)
                for dt in (f64, u8, u8))
    if T and Nref:
        span = span_chunks(Mref)
        kernels.launch("k5_impute_vote", *k5_arguments(
            dev, seg_off, seg_jref, seg_s, seg_e, pitched_rows(Xref), kold,
            ref_freq, span, window_buffers(seg_e, T, Nref, span), out))
    return out


def pitched_rows(Xref: torch.Tensor) -> torch.Tensor:
    """The (Mref, Nref) uint8 rows as K5 reads them: 16-byte aligned, each
    row ``Xref.stride(0)`` bytes from the last, a multiple of 16 whatever
    Nref is (the kernel bulk-copies a row's chunk rounded up to 16 bytes).
    Xref itself where it is laid out so, else a copy into rows of Nref
    rounded up to 16, the bytes past Nref zero."""
    (Mref, Nref), (rs, cs) = Xref.shape, Xref.stride()
    pitch = -(-Nref // 16) * 16
    held = Xref.untyped_storage().nbytes() - Xref.storage_offset()
    if ((cs == 1 or Nref == 1) and rs % 16 == 0 and rs >= pitch
            and Xref.data_ptr() % 16 == 0 and held >= (Mref - 1) * rs + pitch):
        return Xref
    out = torch.empty((Mref, pitch), dtype=torch.uint8, device=Xref.device)
    out[:, Nref:].zero_()
    return out[:, :Nref].copy_(Xref)


def reference_rows(Xcols: np.ndarray, device=None) -> torch.Tensor:
    """Site-major (Nref, Mref) donor alleles -> the (Mref, Nref) uint8 rows
    :func:`impute_dosages_device` reads, transposed on the device into
    :func:`pitched_rows`' layout."""
    dev = resolve_device(device)
    return pitched_rows(torch.from_numpy(
        np.ascontiguousarray(Xcols, np.uint8)).to(dev).t())


def segment_columns(segments: np.ndarray, n_targets: int):
    """(seg_off int64 (T+1,), jref, start, end int32) of (nseg, 4) rows
    (target, donor, start, end), sorted here by (target, start)."""
    segs = segments[np.lexsort((segments[:, 2], segments[:, 0]))]
    off = np.zeros(n_targets + 1, np.int64)
    np.cumsum(np.bincount(segs[:, 0], minlength=n_targets), out=off[1:])
    return (off, *(np.ascontiguousarray(segs[:, c], np.int32)
                   for c in (1, 2, 3)))


def impute_dosages_device(segments: np.ndarray, n_targets: int, Xref_nat,
                          kold_of_kref: np.ndarray, ref_freq: np.ndarray,
                          device=None):
    """Weighted-vote imputation on ``device``, the contract of
    ``pbwt_tpu.ops.impute_jax.impute_dosages_device``.

    segments: (nseg, 4) integer rows (target j, donor jref, start, end) in
              frame coordinates
    Xref_nat: (Mref, Nref) uint8 reference alleles in natural order, a
              numpy array or a tensor already on the device
              (:func:`reference_rows`)
    kold_of_kref: (Nref,) frame coordinate of each reference site
    ref_freq:  (Nref,) fallback allele frequency per site

    Returns (x, dosage, voted): (T, Nref) imputed alleles uint8, posterior
    f64, and the covered-by-any-match mask, as numpy arrays.
    """
    dev = resolve_device(device)
    if not torch.is_tensor(Xref_nat):
        Xref_nat = torch.from_numpy(np.ascontiguousarray(Xref_nat, np.uint8))
    off, jref, s, e, kold, freq = upload_columns(segments, n_targets,
                                                 kold_of_kref, ref_freq, dev)
    return download(*impute_vote(off, jref, s, e, Xref_nat.to(dev), kold,
                                 freq))


def upload_columns(segments, n_targets, kold_of_kref, ref_freq, dev):
    """The vote's inputs on dev: :func:`segment_columns` of the segments,
    then kold as int32 and ref_freq as float64."""
    cols = (*segment_columns(np.asarray(segments), n_targets),
            np.asarray(kold_of_kref, np.int32),
            np.asarray(ref_freq, np.float64))
    return tuple(torch.from_numpy(c).to(dev) for c in cols)


def download(dosage, x, voted):
    """The vote's (x, dosage, voted) as numpy arrays, voted as bool."""
    return (x.cpu().numpy(), dosage.cpu().numpy(),
            voted.cpu().numpy().astype(bool))
