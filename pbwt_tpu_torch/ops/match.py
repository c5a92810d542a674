"""Standing-panel set-maximal matching on the device.

Counterpart of ``pbwt_tpu/ops/match_jax.py`` (the trajectory path of
``DeviceMatcher``). Three stages, as there:

1. :func:`panel_trajectory`: the panel advances once through the
   divergence-carrying partition (kernel K2) and leaves per site the
   pre-site prefix array, the post-site divergence array, the FM rank table
   and the zero count in device memory, as plain int32 (12 B per hap-site).
   :func:`rank_plane` (kernel ``k3_rank_plane``) then packs the rank table
   into a bit plane with a rank a block, 1/24 of its bytes, which is what
   the query scan reads; the int32 rank table is dropped.
2. :func:`match_scan_indexed`: kernel K3 walks every query over the stored
   tables and appends a record of each interval collapse.
3. :func:`expand_rows`: the records, sorted by (site, query), and the k = N
   flush expand into (query, haplotype, start, end) rows.

Padding (as the JAX matcher): rows beyond M are duplicates of row 0, which
leave the set-maximal structure unchanged and whose ids (>= M) are dropped
from the reports; sites beyond N are zero bits, identity steps for the panel
and the queries; the flush reports k = N.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import tracing
from ..core import native
from . import kernels, resolve_device
from .build import pad_to
from .partition import GROUP, ad_trajectory

ROW_MULTIPLE = 2048                 # matcher rows pad to this multiple
TRAJ_BYTES = 48 << 30               # trajectory budget on an 80 GB card
REC_CAP = 1 << 17                   # first record-buffer size
REC_INTS = 5                        # record: (k, q, e_old, f_old, g_old)
PLANE_WORDS = kernels.PLANE_WORDS   # int32 words a block of the rank plane

# bit-reversal of a byte: packbits order (site 8j at bit 7) -> site 8j at bit 0
_REV8 = [int(f"{i:08b}"[::-1], 2) for i in range(256)]


def pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _packed_rows(X: np.ndarray, rows: int, width: int) -> np.ndarray:
    """(R, N) 0/1 -> (rows, width) uint8 numpy packbits rows (site j at bit
    7 - (j & 7) of byte j >> 3), zero beyond N; rows R .. rows-1 repeat row
    0 (the matcher's padding rows)."""
    bits = np.packbits(np.ascontiguousarray(X, np.uint8), axis=1)
    out = np.zeros((rows, width), np.uint8)
    out[:len(bits), :bits.shape[1]] = bits
    if rows > len(bits):
        out[len(bits):] = out[0]
    return out


def pack_row_words(X: np.ndarray, nw: int) -> np.ndarray:
    """(R, N) 0/1 -> (R, nw) int32 row words, numpy packbits bytes read as
    little-endian int32 (site j in word j >> 5, bit 8*((j>>3)&3) + 7-(j&7)),
    zero beyond N."""
    return _packed_rows(X, X.shape[0], 4 * nw).view(np.int32)


def _reverse_bits(x: torch.Tensor) -> torch.Tensor:
    """Each byte of a uint8 tensor with its bits in reverse order (packbits
    order, site 8j at bit 7, to site 8j at bit 0), in temporaries of the
    tensor's own size."""
    x = (x >> 4) | (x << 4)
    x = ((x >> 2) & 0x33) | ((x & 0x33) << 2)
    return ((x >> 1) & 0x55) | ((x & 0x55) << 1)


def panel_trajectory(W: torch.Tensor, a0: torch.Tensor, d0: torch.Tensor):
    """Per-site panel tables for the query scan.

    W (Ng, Mp) int32 group words in natural order; a0, d0 (Mp,) the start
    prefix and divergence arrays. Returns (A (Ns+1, Mp): A[k] the prefix
    array before site k and A[Ns] the final one; D (Ns, Mp): the divergence
    array after site k; U (Ns, Mp): the exclusive zero ranks of site k over
    the pre-site order; C (Ns,): zeros at site k), all int32, Ns = Ng*32.
    On the card the tables are filled by one launch of kernel K2.
    """
    return ad_trajectory(W, a0, d0)


def plane_blocks(Mp: int) -> int:
    """Blocks a site of the rank plane: position Mp has a block too."""
    return Mp // (32 * (PLANE_WORDS - 1)) + 1


def rank_plane_plain(U: torch.Tensor, C: torch.Tensor,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of :func:`rank_plane`, 256 sites at a time."""
    Ns, Mp = U.shape
    words, nblk, rows = PLANE_WORDS, plane_blocks(Mp), 32 * (PLANE_WORDS - 1)
    plane = out if out is not None else torch.empty(
        (Ns, nblk, words), dtype=torch.int32, device=U.device)
    weight = torch.ones(32, dtype=torch.int64, device=U.device) \
        << torch.arange(32, device=U.device)
    for k0 in range(0, Ns, 256):
        u, c = U[k0:k0 + 256], C[k0:k0 + 256, None]
        # ranks at 0 .. nblk*rows: U, then the count at and beyond Mp
        r = torch.cat([u, c.expand(-1, nblk * rows + 1 - Mp)], 1)
        bits = (r[:, 1:] - r[:, :-1]).view(-1, nblk, words - 1, 32).long()
        plane[k0:k0 + 256, :, 0] = r[:, :-1:rows]
        plane[k0:k0 + 256, :, 1:] = (bits * weight).sum(-1).to(torch.int32)
    return plane


def rank_plane(U: torch.Tensor, C: torch.Tensor,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """The FM rank table as a bit plane (kernel ``k3_rank_plane``).

    U (Ns, Mp) int32: the zeros of site k before position i of the pre-site
    order; C (Ns,) the zeros of site k. Returns (Ns, nblk, PLANE_WORDS)
    int32, nblk = :func:`plane_blocks`: block b of a site holds the rank at
    its first row, b * 32 * (PLANE_WORDS - 1), then one bit a row (1: a
    zero), row j of a word at bit j; rows at and beyond Mp hold no bit, so
    :func:`plane_rank` gives U[k][i] for i < Mp and C[k] at i = Mp. out: a
    plane of that shape to fill in place of a new one.
    """
    Ns, Mp = U.shape
    shape = (Ns, plane_blocks(Mp), PLANE_WORDS)
    if C.numel() != Ns or (out is not None and tuple(out.shape) != shape):
        raise ValueError("rank_plane: inconsistent table shapes")
    if U.device.type == "cpu":
        return rank_plane_plain(U, C, out)
    plane = out if out is not None else torch.empty(
        shape, dtype=torch.int32, device=U.device)
    dev = kernels.cuda_tensors(U, C, plane)
    kernels.launch("k3_rank_plane", dev.index, U.data_ptr(), C.data_ptr(),
                   Ns, Mp, plane.data_ptr(), kernels.stream(dev))
    return plane


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """Set bits of each value in [0, 2^32) of an int64 tensor."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) >> 24) & 0xFF


def plane_rank(plane: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Ranks read from a rank plane (..., nblk, words) at the positions i
    (n,) int64 in [0, Mp]: (..., n) int64, the block's rank plus the set
    bits below the position, as kernel K3 reads them."""
    words = plane.shape[-1]
    b = torch.div(i, 32 * (words - 1), rounding_mode="floor")
    r = i - b * (32 * (words - 1))
    blk = plane[..., b, :].long()
    rank = blk[..., 0]
    for m in range(words - 1):
        mask = (torch.ones_like(r) << (r - 32 * m).clamp(0, 32)) - 1
        rank = rank + _popcount32(blk[..., 1 + m] & 0xFFFFFFFF & mask)
    return rank


def _query_bit(xq_words: torch.Tensor, j: int) -> torch.Tensor:
    """Site j of every query row (row-word layout of pack_row_words)."""
    return (xq_words[:, j >> 5] >> (8 * ((j >> 3) & 3) + 7 - (j & 7))) & 1


def _site_order(v: int) -> int:
    """Row word (as unsigned) with site j of the word moved to bit j."""
    return int.from_bytes(bytes(_REV8[x] for x in v.to_bytes(4, "little")),
                          "little")


def match_scan_indexed_plain(plane, D, A, C, xq_words, xp_words, e, f, g,
                             cap: int, first_site: int = 0):
    """Plain twin of :func:`match_scan_indexed`: the FM step runs over all
    queries per site, the (rare) resets one query at a time on the host,
    in (site, query) order."""
    Ns, Mp = D.shape
    Q, nw = xq_words.shape
    e, f, g = e.clone(), f.clone(), g.clone()
    dev = D.device
    rec = torch.full((cap, REC_INTS), -1, dtype=torch.int32, device=dev)
    recs = []
    xq_h = xq_words.cpu().numpy().view(np.uint32)
    xp_h = xp_words.cpu().numpy().view(np.uint32)
    for k in range(Ns):
        kg = first_site + k                    # the tables' row k
        c = C[k].long()
        x = _query_bit(xq_words, kg)
        fl, gl = f.long(), g.long()
        uf, ug = plane_rank(plane[k], torch.cat([fl, gl])).view(2, Q)
        f1 = torch.where(x != 0, c + fl - uf, uf)
        g1 = torch.where(x != 0, c + gl - ug, ug)
        coll = torch.nonzero(g1 <= f1).flatten().tolist()
        if coll:
            dk = D[k].cpu().numpy()
            ak = A[k + 1].cpu().numpy()
            e_h, f_h, g_h = e.tolist(), f.tolist(), g.tolist()
            f1_h, g1_h = f1.tolist(), g1.tolist()
            for q in coll:
                recs.append((kg, q, e_h[q], f_h[q], g_h[q]))
                e_h[q], f_h[q], g_h[q] = _reset(
                    kg, f1_h[q], g1_h[q], dk, ak, xq_h[q], xp_h, Mp, nw)
            e, f, g = (torch.tensor(v, dtype=torch.int32, device=dev)
                       for v in (e_h, f_h, g_h))
            keep = ~(g1 <= f1)
            f = torch.where(keep, f1.to(torch.int32), f)
            g = torch.where(keep, g1.to(torch.int32), g)
        else:
            f, g = f1.to(torch.int32), g1.to(torch.int32)
    if recs:
        n = min(len(recs), cap)
        rec[:n] = torch.tensor(recs[:n], dtype=torch.int32)
    nrec = torch.tensor([len(recs)], dtype=torch.int32, device=dev)
    return e, f, g, rec, nrec


def _reset(k, f1, g1, dk, ak, xq, xp, Mp, nw):
    """The reference's post-collapse reset (pbwtMatch.c:309-320) of one
    query at global site k, dk and ak the divergence and prefix arrays after
    it; returns the new (e, f, g)."""
    def bit(j):
        return (int(xq[j >> 5]) >> (8 * ((j >> 3) & 3) + 7 - (j & 7))) & 1

    e1 = (k + 2 if f1 >= Mp else int(dk[f1])) - 1
    branch_a = f1 == Mp or (f1 > 0 and bit(min(max(e1, 0), nw * 32 - 1)) == 0)
    fsel = g1 - 1 if branch_a else f1
    if e1 > 0:
        hap = int(ak[min(max(fsel, 0), Mp - 1)])
        j = e1 - 1
        mask = (1 << ((j & 31) + 1)) - 1
        last = -1
        for wi in range(j >> 5, -1, -1):
            v = _site_order(int(xq[wi] ^ xp[hap, wi])) & mask
            mask = 0xFFFFFFFF
            if v:
                last = 32 * wi + v.bit_length() - 1
                break
        e1 = last + 1
    if branch_a:
        fn = fsel
        while fn >= 0 and dk[fn] <= e1:
            fn -= 1
        return e1, fn, g1
    gn = f1 + 1
    while gn < Mp and dk[gn] <= e1:
        gn += 1
    return e1, f1, gn


def match_scan_indexed(plane, D, A, C, xq_words, xp_words, e, f, g,
                       cap: int, first_site: int = 0):
    """Query scan against a stored trajectory (kernel K3).

    D (Ns, Mp), A (Ns+1, Mp), C (Ns,) from :func:`panel_trajectory` and
    plane from :func:`rank_plane` of its rank table; their row k is global
    site first_site + k (a multiple of 32), so that a scan can go on over
    the tables of a later stretch of sites from a carried (e, f, g);
    xq_words (Q, nw) and xp_words (Mp, nw) row words of the whole rows, with
    nw*32 >= first_site + Ns; e, f, g (Q,) the starting intervals. Returns
    (e, f, g) after the last site (the flush carry), rec (cap, 5) int32
    records (k, q, e, f, g) of the interval before each collapse, k global,
    and nrec (1,): the number of collapses. nrec > cap means the buffer
    overflowed and the scan must run again with a larger cap. The kernel
    appends records in no fixed order.
    """
    if first_site < 0 or first_site % GROUP:
        raise ValueError(f"match_scan_indexed: first site {first_site} is "
                         f"not a multiple of {GROUP}")
    if plane.device.type == "cpu":
        return match_scan_indexed_plain(plane, D, A, C, xq_words, xp_words,
                                        e, f, g, cap, first_site)
    dev = kernels.cuda_tensors(plane, D, A, C, xq_words, xp_words, e, f, g)
    Ns, Mp = D.shape
    Q, nw = xq_words.shape
    if (nw * 32 < first_site + Ns or A.shape != (Ns + 1, Mp)
            or plane.shape != (Ns, plane_blocks(Mp), PLANE_WORDS)
            or C.numel() != Ns or xp_words.shape != (Mp, nw)
            or not e.numel() == f.numel() == g.numel() == Q):
        raise ValueError("match_scan_indexed: inconsistent table shapes")
    e, f, g = e.clone(), f.clone(), g.clone()
    rec = torch.full((cap, REC_INTS), -1, dtype=torch.int32, device=dev)
    nrec = torch.zeros(1, dtype=torch.int32, device=dev)
    kernels.launch("k3_match_scan", dev.index, plane.data_ptr(),
                   D.data_ptr(), A.data_ptr(), C.data_ptr(),
                   xq_words.data_ptr(),
                   xp_words.data_ptr(), Ns, Mp, Q, nw, int(first_site),
                   e.data_ptr(), f.data_ptr(), g.data_ptr(), rec.data_ptr(),
                   cap, nrec.data_ptr(), kernels.stream(dev))
    return e, f, g, rec, nrec


def sort_records(rec: torch.Tensor, nrec: int, Q: int) -> torch.Tensor:
    """The first nrec records ordered by (site, query)."""
    rec = rec[:nrec]
    return rec[torch.argsort(rec[:, 0].long() * Q + rec[:, 1])]


def expand_rows(A, rec, e, f, g, n_sites: int, first_site: int = 0,
                flush: bool = True) -> torch.Tensor:
    """Records (sorted) then, with flush, the k = N flush -> (n, 4) int32
    rows (q, haplotype, start, end), each record's haplotypes in interval
    order. A (Ns+1, Mp) holds the prefix arrays of the global sites
    first_site .. first_site + Ns, and the records' sites lie among them.
    The flush rows read the final prefix array A[Ns] and report end =
    n_sites; a stretch of sites that is not the last one of its panel
    expands its records alone (flush=False). Flat indices are int64."""
    Ns, Mp = A.shape[0] - 1, A.shape[1]
    dev = A.device
    k = rec[:, 0].long() - first_site
    q, start, lo, hi = rec[:, 1], rec[:, 2], rec[:, 3], rec[:, 4]
    if flush:
        Q = e.numel()
        k = torch.cat([k, torch.full((Q,), Ns, dtype=torch.long, device=dev)])
        q = torch.cat([q, torch.arange(Q, dtype=torch.int32, device=dev)])
        start, lo, hi = (torch.cat([start, e]), torch.cat([lo, f]),
                         torch.cat([hi, g]))
    lo = lo.long()
    width = (hi.long() - lo).clamp(min=0)
    total = int(width.sum())
    rid = torch.repeat_interleave(torch.arange(width.numel(), device=dev),
                                  width, output_size=total)
    first = torch.cumsum(width, 0) - width
    pos = torch.arange(total, device=dev) - first[rid]
    kr = k[rid]
    ids = A.view(-1)[kr * Mp + lo[rid] + pos]
    end = (kr + first_site).to(torch.int32)
    if flush:
        end[rid >= rec.shape[0]] = n_sites
    return torch.stack([q[rid], ids, start[rid], end], 1)


def traj_bytes() -> int:
    """The budget of the trajectory tables: PBWT_TORCH_TRAJ_BYTES, else
    TRAJ_BYTES."""
    return int(os.environ.get("PBWT_TORCH_TRAJ_BYTES", TRAJ_BYTES))


def table_bytes(Mp: int, groups: int) -> int:
    """Bytes of the tables of a trajectory over `groups` groups of sites
    while it is made: A, D and U (12 B a row a site, and A's last row), C,
    and the rank plane."""
    ns = groups * GROUP
    return (12 * Mp * (ns + 1) + 4 * ns
            + 4 * PLANE_WORDS * plane_blocks(Mp) * ns)


class DeviceMatcher:
    """Standing-panel matcher. Where the panel's trajectory fits the budget
    (:func:`traj_bytes`) it is built once on the device at construction and
    :meth:`match` serves query batches from it. A larger panel keeps its
    packed rows and group words alone, and every call walks it in segments
    of ``gseg`` whole groups of sites: the trajectory from the carried
    (a, d), the rank plane, the query scan from the carried (e, f, g), the
    expansion of that segment's records, all in one set of tables sized for
    a segment and made at the first call. The rows are the same, in the
    same order. Construction is the span ``setup.matcher`` and a call of
    :meth:`match` the span ``ops.match``, their stages their children
    (:mod:`pbwt_tpu_torch.tracing`)."""

    def __init__(self, Xp: np.ndarray, device=None):
        with tracing.span("setup.matcher"):
            M, N = Xp.shape
            self._shape_init(M, N, device)
            with tracing.span("setup.matcher.pack"):
                xp_pad = _packed_rows(Xp, self.Mp, 4 * self.Ng)
            with tracing.span("setup.matcher.upload"):
                xp_dev = torch.from_numpy(xp_pad).to(self.device)
            self._finish_init(xp_dev)

    @classmethod
    def from_pbwt(cls, p, device=None, chunk_sites: int = 512):
        """Build from a packed PBWT, decoding the pack3 stream a chunk of
        sites at a time (O(M * chunk) host bytes) instead of materialising
        the (M, N) haplotype matrix."""
        self = cls.__new__(cls)
        with tracing.span("setup.matcher"):
            M, N = p.M, p.N
            self._shape_init(M, N, device)
            a = np.ascontiguousarray(
                p.aFstart if p.aFstart is not None
                else np.arange(M, dtype=np.int32), np.int32)
            chunk_sites = max(8 * -(-chunk_sites // 8), 8)    # whole bytes
            pos = 0
            parts = []
            for k0 in range(0, N, chunk_sites):
                nc = min(chunk_sites, N - k0)
                with tracing.span("setup.matcher.pack"):
                    Xc, a, _, pos = native.natural_cols(
                        p.yz, nc, M, a, start=pos, with_pos=True)
                    pad = _packed_rows(native.transpose_u8(Xc), self.Mp,
                                       -(-nc // 8))
                with tracing.span("setup.matcher.upload"):
                    parts.append(torch.from_numpy(pad).to(self.device))
            nb_have = sum(x.shape[1] for x in parts)
            parts.append(torch.zeros((self.Mp, 4 * self.Ng - nb_have),
                                     dtype=torch.uint8, device=self.device))
            self._finish_init(torch.cat(parts, 1))
        return self

    def _shape_init(self, M: int, N: int, device) -> None:
        self.device = resolve_device(device)
        self.M, self.N = M, N
        self.Mp = pad_to(M, ROW_MULTIPLE)
        self.Ng = -(-N // GROUP)
        # whole groups a segment: as many as the budget holds (one if it
        # holds none), evened out over the segments
        fixed = table_bytes(self.Mp, 0)
        fit = max((traj_bytes() - fixed)
                  // (table_bytes(self.Mp, 1) - fixed), 1)
        self.nseg = -(-max(self.Ng, 1) // fit)
        self.gseg = -(-self.Ng // self.nseg)
        self._caps: dict[int, int] = {}

    def _finish_init(self, xp_pad: torch.Tensor) -> None:
        """Row words and group words from the (Mp, 4*Ng) packbits rows on
        the device; where one segment holds the panel, its trajectory and
        rank plane in place of the group words."""
        with tracing.span("setup.matcher.tables"):
            self.xp_words = xp_pad.view(torch.int32)          # (Mp, Ng)
            W = _reverse_bits(xp_pad).view(torch.int32).t().contiguous()
                                                              # (Ng, Mp)
            self._tables = None
            if self.nseg == 1:
                self.W = None
                self.A, self.D, U, self.C = panel_trajectory(
                    W, *self._start_ad())
                self.plane = rank_plane(U, self.C)
            else:
                self.W = W
                self.A = self.D = self.C = self.plane = None

    def _start_ad(self):
        a0 = torch.arange(self.Mp, dtype=torch.int32, device=self.device)
        d0 = torch.zeros(self.Mp, dtype=torch.int32, device=self.device)
        d0[0] = 1
        return a0, d0

    def _segment(self, seg: int, a, d):
        """(A, D, C, plane) of segment seg of an over-budget panel from the
        prefix and divergence arrays (a, d) that enter it, in the one set of
        tables that all segments fill, made at the first call."""
        if self._tables is None:
            ns, Mp, dev = self.gseg * GROUP, self.Mp, self.device
            self._tables = (
                torch.empty((ns + 1, Mp), dtype=torch.int32, device=dev),
                torch.empty((ns, Mp), dtype=torch.int32, device=dev),
                torch.empty((ns, Mp), dtype=torch.int32, device=dev),
                torch.empty(ns, dtype=torch.int32, device=dev),
                torch.empty((ns, plane_blocks(Mp), PLANE_WORDS),
                            dtype=torch.int32, device=dev))
        g0 = seg * self.gseg
        W = self.W[g0:g0 + self.gseg]
        n = W.shape[0] * GROUP
        tA, tD, tU, tC, tP = self._tables
        A, D, U, C = ad_trajectory(W, a, d, g0 * GROUP,
                                   (tA[:n + 1], tD[:n], tU[:n], tC[:n]))
        return A, D, C, rank_plane(U, C, tP[:n])

    def _match_rows(self, xq_words: torch.Tensor, cap: int):
        """(rows on the device, 0), or (None, the record count that did not
        fit cap in some segment)."""
        Q = xq_words.shape[0]
        e = torch.zeros(Q, dtype=torch.int32, device=self.device)
        f = torch.zeros(Q, dtype=torch.int32, device=self.device)
        g = torch.full((Q,), self.Mp, dtype=torch.int32, device=self.device)
        A, D, C, plane = self.A, self.D, self.C, self.plane   # if standing
        a, d = self._start_ad() if A is None else (None, None)
        out = []
        for seg in range(self.nseg):
            first = seg * self.gseg * GROUP
            tracing.count("ops.match.segments")
            if self.A is None:
                with tracing.span("ops.match.tables"):
                    A, D, C, plane = self._segment(seg, a, d)
                    a, d = A[-1].clone(), D[-1].clone()
            with tracing.span("ops.match.scan"):
                e, f, g, rec, nrec = match_scan_indexed(
                    plane, D, A, C, xq_words, self.xp_words, e, f, g, cap,
                    first)
                nrec = int(nrec)
            tracing.count("ops.match.records", nrec)
            if nrec > cap:
                return None, nrec
            with tracing.span("ops.match.sort"):
                rec = sort_records(rec, nrec, Q)
            with tracing.span("ops.match.expand"):
                out.append(expand_rows(A, rec, e, f, g, self.N, first,
                                       flush=seg == self.nseg - 1))
        return (out[0] if len(out) == 1 else torch.cat(out)), 0

    def match(self, Xq: np.ndarray) -> np.ndarray:
        """Set-maximal matches of the (Q, N) queries: (n, 4) int32 rows
        (q, panel haplotype, start, end) in the JAX matcher's order."""
        Q = Xq.shape[0]
        if Xq.shape[1] != self.N:
            raise ValueError(f"query length {Xq.shape[1]} != panel length "
                             f"{self.N}")
        with tracing.span("ops.match"):
            with tracing.span("ops.match.pack"):
                words = pack_row_words(Xq, self.Ng)
            with tracing.span("ops.match.upload"):
                xq_words = torch.from_numpy(words).to(self.device)
            cap = self._caps.get(Q, pow2_at_least(max(REC_CAP, 128 * Q)))
            while True:
                rows, nrec = self._match_rows(xq_words, cap)
                if rows is not None:
                    break
                tracing.count("ops.match.cap_reruns")
                cap = pow2_at_least(nrec)    # overflow: run again, larger,
                                             # from the first segment
            self._caps[Q] = cap
            with tracing.span("ops.match.filter"):
                rows = rows[rows[:, 1] < self.M]
            with tracing.span("ops.match.download"):
                rows = rows.cpu().numpy()
        tracing.count("ops.match.queries", Q)
        tracing.count("ops.match.rows", len(rows))
        tracing.count("ops.match.download_bytes", rows.nbytes)
        return rows


def match_queries_device(Xp: np.ndarray, Xq: np.ndarray, device=None
                         ) -> np.ndarray:
    """Set-maximal matches of the (Q, N) queries Xq against the (M, N) panel
    Xp with nothing standing: upload, trajectory, rank plane, scan and
    expansion in one call, through :class:`DeviceMatcher`. Counterpart of
    ``pbwt_tpu.ops.match_jax.match_queries_device``: (n, 4) int32 rows
    (q, panel haplotype, start, end) in its order."""
    return DeviceMatcher(Xp, device=device).match(Xq)
