"""Reference imputation's weighted vote on the device (kernel K5) and its
output stage (kernel K8).

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

K8 (``csrc/impute_emit.cu``) turns K5's (T, Nref) results into what the
imputed panel holds without their leaving the card: each site's four sums
for the info scores and the code bytes (:func:`vote_sums`, ``k8_sums``), the
sites' code rows in each site's sort order and the last prefix array
(:func:`sort_codes`, ``k8_chain``, one block walking the sites in order) and
the pack3 and dosage streams (:func:`encode_rows`, ``k8_encode``); the host
C pass ``impute_emit`` and ``_vote_sums`` to the byte and to the bit. Their
plain twins (``*_plain``) run on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.pack3 import ENCODE_MAX1, ENCODE_MAX2, ENCODE_MAX3
from . import kernels, resolve_device
from .likelihood import SMEM_OPTIN
from .partition import _cummax

TWIN_ELEMENTS = 1 << 24     # (segment, site) pairs a step of the plain twin
CHUNK, SPAN_MAX = kernels.K5_LAYOUT   # sites a chunk, most chunks a span
# the slab of donor alleles that the blocks running at one time read, Mref x
# span x CHUNK bytes, is kept this far under the card's 50 MB L2
SPAN_L2_BYTES = 40 << 20
_LIFT = 1 << 31             # int32 values shifted to be non-negative

# K8's chain block: shared bytes before the prefix array, rows of the ring,
# most threads, positions a thread of the wide chain
CHAIN_FIXED, CHAIN_SLOTS, CHAIN_MAX_THREADS, WIDE_PER = kernels.K8_LAYOUT
CHAIN_PER = (8, 16, 32)     # positions a thread of the chain block
CHAIN_WIDE = 256            # threads, past which a thread takes more positions
# the most targets whose prefix array the chain block holds in shared memory:
# 32 positions a thread, 1,024 threads; past it the wide chain
CHAIN_SHARED_TARGETS = CHAIN_PER[-1] * CHAIN_MAX_THREADS


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
    :func:`impute_vote` reads, transposed on the device into
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


def download(dosage, x, voted):
    """The vote's (x, dosage, voted) as numpy arrays, voted as bool."""
    return (x.cpu().numpy(), dosage.cpu().numpy(),
            voted.cpu().numpy().astype(bool))


# --------------------------------------------------------------------------
# K8: the output stage on the card
# --------------------------------------------------------------------------

def code_pitch(T: int) -> int:
    """Bytes a row of the site-major code bytes: T rounded up to 16."""
    return -(-T // 16) * 16


def chain_config(T: int, smem: int = SMEM_OPTIN):
    """(positions a thread, threads, wide) of ``k8_chain``'s block for T
    targets, or None where T is 0. Up to CHAIN_SHARED_TARGETS (32,768), where
    the prefix array (2 bytes a target) and a ring of CHAIN_SLOTS code rows
    fit the block's `smem` shared bytes (232,448 on the H100), they stay
    there, and a thread takes the fewest of CHAIN_PER positions that keep the
    block within CHAIN_WIDE threads, else the most. Past it the wide chain:
    the prefix array in global memory, WIDE_PER positions a thread, tiles of
    at most CHAIN_MAX_THREADS threads."""
    if T <= 0:
        return None
    if (T <= CHAIN_SHARED_TARGETS
            and CHAIN_FIXED + (2 + CHAIN_SLOTS) * code_pitch(T) <= smem):
        per = next((p for p in CHAIN_PER if -(-T // p) <= CHAIN_WIDE),
                   CHAIN_PER[-1])
        return per, -(-T // (32 * per)) * 32, False
    return (WIDE_PER,
            min(CHAIN_MAX_THREADS, -(-T // (32 * WIDE_PER)) * 32), True)


def emit_config(T: int, dev: torch.device):
    """:func:`chain_config` for the card ``dev``; for the CPU, where the
    twins run, that of the H100."""
    if dev.type != "cuda":
        return chain_config(T)
    props = torch.cuda.get_device_properties(dev)
    return chain_config(T, getattr(props, "shared_memory_per_block_optin",
                                   SMEM_OPTIN))


def dosage_symbols(dosage: torch.Tensor) -> torch.Tensor:
    """dosageEncode (pbwtImpute.c:1631-1641) elementwise: 6 levels of the
    dosage's distance from its allele, uint8."""
    dd = torch.where(dosage > 0.5, 1.0 - dosage, dosage)
    return torch.where(dd == 0.0, 0, (10.0 * (dd + 0.0999999)).long()
                       ).to(torch.uint8)


def vote_sums_plain(dosage, x, voted):
    """Plain twin of :func:`vote_sums`: a target's row at a time, in
    order."""
    T, Nref = dosage.shape
    count = torch.zeros(Nref, dtype=torch.int64)
    ones = torch.zeros(Nref, dtype=torch.int64)
    psum = torch.zeros(Nref, dtype=torch.float64)
    pxsum = torch.zeros(Nref, dtype=torch.float64)
    zero = torch.zeros(Nref, dtype=torch.float64)
    for t in range(T):
        v = voted[t] != 0
        vx = v & (x[t] != 0)
        count += v
        ones += vx
        psum += torch.where(v, dosage[t], zero)
        pxsum += torch.where(vx, dosage[t], zero)
    codes = torch.zeros((Nref, code_pitch(T)), dtype=torch.uint8)
    codes[:, :T] = (((x != 0).to(torch.uint8) << 3)
                    | dosage_symbols(dosage)).t()
    return torch.stack((count.double(), psum, ones.double(), pxsum)), codes


def vote_sums(dosage, x, voted):
    """Each reference site's sums over the targets that voted, and the
    vote's code bytes (``k8_sums``).

    dosage (T, Nref) float64, x and voted (T, Nref) uint8: K5's outputs.
    Returns (sums (4, Nref) float64: the count of targets that voted, their
    sum of dosages, of alleles and of dosage x allele, added in target order
    as numpy's axis-0 sums of ``_vote_sums`` add them; codes (Nref,
    :func:`code_pitch`) uint8: x << 3 | :func:`dosage_symbols`, 0 past T).
    """
    if dosage.device.type == "cpu":
        return vote_sums_plain(dosage, x, voted)
    u8 = torch.uint8
    dev = kernels.typed_cuda_tensors((dosage, torch.float64), (x, u8),
                                     (voted, u8))
    T, Nref = dosage.shape
    if x.shape != dosage.shape or voted.shape != dosage.shape:
        raise ValueError("vote_sums: inconsistent shapes")
    sums = torch.zeros((4, Nref), dtype=torch.float64, device=dev)
    codes = torch.empty((Nref, code_pitch(T)), dtype=u8, device=dev)
    if T and Nref:
        kernels.launch("k8_sums", dev.index, dosage.data_ptr(), x.data_ptr(),
                       voted.data_ptr(), T, Nref, codes.shape[1],
                       sums.data_ptr(), codes.data_ptr(), kernels.stream(dev))
    return sums, codes


def sort_codes_plain(codes, T):
    """Plain twin of :func:`sort_codes`: a site at a time, the row gathered
    through the prefix array, which is then stably partitioned by the
    allele bit."""
    a = torch.arange(T)
    out = torch.zeros_like(codes)
    for k in range(codes.shape[0]):
        y = codes[k, a]
        out[k, :T] = y
        one = (y & 8) != 0
        a = torch.cat((a[~one], a[one]))
    return out, a.to(torch.int32)


def sort_codes(codes, T):
    """The code rows in each site's sort order, and the last prefix array
    (``k8_chain``, one block over the sites in order).

    codes (Nref, pitch) uint8 as :func:`vote_sums` makes them. Returns
    (sorted (Nref, pitch) uint8: row k is codes[k, a_k], a_k the prefix
    array of the sites before k from the identity, each site's allele bit
    (bit 3) partitioning it stably as fwd_a does, 0 past T; a_end (T,)
    int32: the prefix array after the last site)."""
    if codes.device.type == "cpu":
        return sort_codes_plain(codes, T)
    dev = kernels.typed_cuda_tensors((codes, torch.uint8))
    Nref, pitch = codes.shape
    if pitch != code_pitch(T):
        raise ValueError(f"sort_codes: a {pitch}-byte row for {T} targets")
    if not T or not Nref:
        return codes.clone(), torch.arange(T, dtype=torch.int32, device=dev)
    return _chain(codes, T, *emit_config(T, dev))


def _chain(codes, T, per, threads, wide):
    """``k8_chain`` at a configuration of :func:`chain_config`'s."""
    dev = codes.device
    Nref, pitch = codes.shape
    out = torch.empty_like(codes)
    a_end = torch.empty(T, dtype=torch.int32, device=dev)
    prefix = (torch.empty((2, pitch), dtype=torch.int32, device=dev)
              if wide else None)
    kernels.launch("k8_chain", dev.index, codes.data_ptr(), T, Nref, pitch,
                   per, threads, None if prefix is None else prefix.data_ptr(),
                   out.data_ptr(), a_end.data_ptr(), kernels.stream(dev))
    return out, a_end


def _pack3_bytes(sym, n):
    """emit_run's bytes for runs (sym, n): (values, repeats), (runs, 4)
    each: the full-length bytes, then up to three of the remainder's."""
    top = sym << 7
    q = n // ENCODE_MAX3
    r = n - q * ENCODE_MAX3
    b2 = r >= ENCODE_MAX2
    v2 = top | 0x60 | (r >> 11)
    r = torch.where(b2, r & 0x7FF, r)
    b1 = r >= ENCODE_MAX1
    v1 = top | 0x40 | (r >> 6)
    r = torch.where(b1, r & 0x3F, r)
    return (torch.stack((top | 0x7F, v2, v1, top | r), 1),
            torch.stack((q, b2.long(), b1.long(), (r > 0).long()), 1))


def _dosage_bytes(d, n):
    """dos_emit's bytes for runs (symbol d, n) as :func:`_pack3_bytes`
    gives pack3's: a zero run's escapes of 31 << 10, 2^10 and 2^5 and its
    count, or a run's bytes of 31 and its last."""
    zero = d == 0
    q0 = torch.where(n >= 1 << 15, (n - (1 << 15)) // (31 << 10) + 1, 0)
    r = n - q0 * (31 << 10)
    b7 = zero & (r >= 1 << 10)
    v7 = (7 << 5) | (r >> 10)
    r = torch.where(b7, r & 1023, r)
    b6 = zero & (r >= 1 << 5)
    v6 = (6 << 5) | (r >> 5)
    r = torch.where(b6, r & 31, r)
    q1 = (n - 1) // 31
    return (torch.stack((torch.where(zero, 0xFF, (d << 5) | 31), v7, v6,
                         torch.where(zero, r, (d << 5) | (n - 31 * q1))), 1),
            torch.stack((torch.where(zero, q0, q1), b7.long(), b6.long(),
                         torch.ones_like(n)), 1))


def _run_bytes(v, coder):
    """The bytes of each row's runs of v (Nref, T) in order, as ``coder``
    writes a run, and each row's count of them."""
    Nref, T = v.shape
    start = torch.ones_like(v, dtype=torch.bool)
    start[:, 1:] = v[:, 1:] != v[:, :-1]
    at = torch.nonzero(start.flatten()).flatten()
    n = torch.diff(at, append=at.new_tensor([Nref * T]))
    vals, reps = coder(v.flatten()[at], n)
    out = torch.repeat_interleave(vals.flatten(), reps.flatten())
    count = torch.zeros(Nref, dtype=torch.int64).index_add_(
        0, at // T, reps.sum(1))
    return out.to(torch.uint8), count


def encode_rows_plain(rows, T):
    """Plain twin of :func:`encode_rows`: every row's runs at once."""
    y = rows[:, :T].long()
    yz, _ = _run_bytes((y >> 3) & 1, _pack3_bytes)
    zd, count = _run_bytes(y & 7, _dosage_bytes)
    return yz, zd, torch.cumsum(count, 0) - count


def encode_rows(rows, T):
    """The imputed panel's streams from the sorted code rows (``k8_encode``:
    a pass that counts each site's bytes, the offsets as a scan over the
    sites, a pass that writes them).

    rows (Nref, pitch) uint8 as :func:`sort_codes` makes them. Returns (yz
    uint8: the pack3 bytes of each row's alleles, site after site; zd
    uint8: the dosage stream of each row's symbols (dosageStore's run-length
    codes); dos_off (Nref,) int64: where each site's codes start in zd):
    native.impute_emit's bytes."""
    if rows.device.type == "cpu":
        return encode_rows_plain(rows, T)
    dev = kernels.typed_cuda_tensors((rows, torch.uint8))
    Nref, pitch = rows.shape
    if not T or not Nref:
        none = torch.empty(0, dtype=torch.uint8, device=dev)
        return none, none, torch.zeros(Nref, dtype=torch.int64, device=dev)
    counts = torch.empty((2, Nref), dtype=torch.int32, device=dev)
    args = (dev.index, rows.data_ptr(), T, Nref, pitch, counts.data_ptr())
    kernels.launch("k8_encode", *args, None, None, None, kernels.stream(dev))
    ends = torch.cumsum(counts, 1, dtype=torch.int64)
    offsets = ends - counts
    ny, nd = ends[:, -1].tolist()
    yz = torch.empty(ny, dtype=torch.uint8, device=dev)
    zd = torch.empty(nd, dtype=torch.uint8, device=dev)
    kernels.launch("k8_encode", *args, offsets.data_ptr(), yz.data_ptr(),
                   zd.data_ptr(), kernels.stream(dev))
    return yz, zd, offsets[1]


def download_emit(yz, zd, dos_off, a_end, staging=None):
    """The output stage's (yz, zd, dos_off, a_end) on the host: (bytes,
    bytes, int64 array, int32 array, staging). On a card the four go into
    one buffer there, dos_off and a_end first, and cross in one copy into
    ``staging``, a pinned uint8 buffer on the host, made or made larger
    here when it is too small and returned for the next call."""
    if yz.device.type == "cpu":
        return (yz.numpy().tobytes(), zd.numpy().tobytes(), dos_off.numpy(),
                a_end.numpy(), staging)
    Nref, T = dos_off.numel(), a_end.numel()
    u8 = torch.uint8
    packed = torch.cat((dos_off.view(u8), a_end.view(u8), yz, zd))
    n = packed.numel()
    if staging is None or staging.numel() < n:
        staging = torch.empty(n + n // 4, dtype=u8, pin_memory=True)
    host = staging[:n].copy_(packed).numpy()
    cut = np.cumsum([8 * Nref, 4 * T, yz.numel()])
    return (host[cut[1]:cut[2]].tobytes(), host[cut[2]:].tobytes(),
            host[:cut[0]].view(np.int64).copy(),
            host[cut[0]:cut[1]].view(np.int32).copy(), staging)
