"""Reference imputation's weighted vote on the device (kernel K5).

Counterpart of ``pbwt_tpu/ops/impute_jax.py``. Per target haplotype and
reference site, the maximal-match segments that cover the site vote with the
weights w = (k - start)(end - k), k the site's frame coordinate
(referenceImpute3, pbwtImpute.c:1204-1232). The JAX pass takes each target's
sums as an f32 cumulative-sum difference over (nseg, chunk) arrays; here
kernel ``k5_impute_vote`` sums each (target, site)'s own covering segments in
f64, in segment order, so the dosages are the host C pass's to the bit: the
weights are integers and the sums exact below 2^53.
"""

from __future__ import annotations

import numpy as np
import torch

from . import kernels, resolve_device

TWIN_ELEMENTS = 1 << 24     # (segment, site) pairs a step of the plain twin


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
        (Xref, u8), (kold, i32), (ref_freq, f64))
    T, (Mref, Nref) = seg_off.numel() - 1, Xref.shape
    nseg = seg_jref.numel()
    if (seg_s.numel() != nseg or seg_e.numel() != nseg
            or kold.numel() != Nref or ref_freq.numel() != Nref or T < 0):
        raise ValueError("impute_vote: inconsistent shapes")
    dosage = torch.empty((T, Nref), dtype=f64, device=dev)
    x = torch.empty((T, Nref), dtype=u8, device=dev)
    voted = torch.empty((T, Nref), dtype=u8, device=dev)
    kernels.launch("k5_impute_vote", dev.index, seg_off.data_ptr(),
                   seg_jref.data_ptr(), seg_s.data_ptr(), seg_e.data_ptr(), T,
                   Xref.data_ptr(), Nref, kold.data_ptr(),
                   ref_freq.data_ptr(), dosage.data_ptr(), x.data_ptr(),
                   voted.data_ptr(), kernels.stream(dev))
    return dosage, x, voted


def reference_rows(Xcols: np.ndarray, device=None) -> torch.Tensor:
    """Site-major (Nref, Mref) donor alleles -> the (Mref, Nref) uint8 rows
    :func:`impute_dosages_device` reads, transposed on the device."""
    dev = resolve_device(device)
    return torch.from_numpy(np.ascontiguousarray(Xcols, np.uint8)).to(dev) \
        .t().contiguous()


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
    Xref = Xref_nat.to(dev)
    off, jref, s, e = (torch.from_numpy(c).to(dev)
                       for c in segment_columns(np.asarray(segments),
                                                n_targets))
    kold = torch.from_numpy(np.asarray(kold_of_kref, np.int32)).to(dev)
    freq = torch.from_numpy(np.asarray(ref_freq, np.float64)).to(dev)
    dosage, x, voted = impute_vote(off, jref, s, e, Xref, kold, freq)
    return (x.cpu().numpy(), dosage.cpu().numpy(),
            voted.cpu().numpy().astype(bool))
