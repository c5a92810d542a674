"""Standing-panel set-maximal matching on the device.

Counterpart of ``pbwt_tpu/ops/match_jax.py`` (the trajectory path of
``DeviceMatcher``). Three stages, as there:

1. :func:`panel_trajectory`: the panel advances once through the
   divergence-carrying partition (kernel K2) and leaves per site the
   pre-site prefix array, the post-site divergence array, the FM rank table
   and the zero count in device memory, as plain int32 (12 B per hap-site).
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

import numpy as np
import torch

from ..core import native
from . import kernels, resolve_device
from .build import pad_to
from .partition import GROUP, partition_ad_step

ROW_MULTIPLE = kernels.K2_BLOCK     # matcher rows pad to K2's block
TRAJ_BYTES = 48 << 30               # trajectory budget on an 80 GB card
REC_CAP = 1 << 17                   # first record-buffer size
REC_INTS = 5                        # record: (k, q, e_old, f_old, g_old)

# bit-reversal of a byte: packbits order (site 8j at bit 7) -> site 8j at bit 0
_REV8 = [int(f"{i:08b}"[::-1], 2) for i in range(256)]
_BITREV = torch.tensor(_REV8, dtype=torch.uint8)


def pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def pack_row_words(X: np.ndarray, nw: int) -> np.ndarray:
    """(R, N) 0/1 -> (R, nw) int32 row words, numpy packbits bytes read as
    little-endian int32 (site j in word j >> 5, bit 8*((j>>3)&3) + 7-(j&7)),
    zero beyond N."""
    bits = np.packbits(np.ascontiguousarray(X, np.uint8), axis=1)
    out = np.zeros((X.shape[0], 4 * nw), np.uint8)
    out[:, :bits.shape[1]] = bits
    return out.view(np.int32)


def panel_trajectory(W: torch.Tensor, a0: torch.Tensor, d0: torch.Tensor):
    """Per-site panel tables for the query scan.

    W (Ng, Mp) int32 group words in natural order; a0, d0 (Mp,) the start
    prefix and divergence arrays. Returns (A (Ns+1, Mp): A[k] the prefix
    array before site k and A[Ns] the final one; D (Ns, Mp): the divergence
    array after site k; U (Ns, Mp): the exclusive zero ranks of site k over
    the pre-site order; C (Ns,): zeros at site k), all int32, Ns = Ng*32.
    """
    Ng, Mp = W.shape
    Ns = Ng * GROUP
    dev = W.device
    A = torch.empty((Ns + 1, Mp), dtype=torch.int32, device=dev)
    D = torch.empty((Ns, Mp), dtype=torch.int32, device=dev)
    U = torch.empty((Ns, Mp), dtype=torch.int32, device=dev)
    C = torch.empty(Ns, dtype=torch.int32, device=dev)
    A[0] = a0
    d = d0
    for t in range(Ng):
        w = W[t][A[GROUP * t].long()]
        for s in range(GROUP):
            k = GROUP * t + s
            _, d, w, _, _ = partition_ad_step(
                A[k], d, w, s, k, out=(A[k + 1], D[k], None, U[k],
                                       C[k:k + 1]))
    return A, D, U, C


def _query_bit(xq_words: torch.Tensor, j: int) -> torch.Tensor:
    """Site j of every query row (row-word layout of pack_row_words)."""
    return (xq_words[:, j >> 5] >> (8 * ((j >> 3) & 3) + 7 - (j & 7))) & 1


def _site_order(v: int) -> int:
    """Row word (as unsigned) with site j of the word moved to bit j."""
    return int.from_bytes(bytes(_REV8[x] for x in v.to_bytes(4, "little")),
                          "little")


def match_scan_indexed_plain(U, D, A, C, xq_words, xp_words, e, f, g,
                             cap: int):
    """Plain twin of :func:`match_scan_indexed`: the FM step runs over all
    queries per site, the (rare) resets one query at a time on the host,
    in (site, query) order."""
    Ns, Mp = U.shape
    Q, nw = xq_words.shape
    e, f, g = e.clone(), f.clone(), g.clone()
    rec = torch.full((cap, REC_INTS), -1, dtype=torch.int32,
                     device=U.device)
    recs = []
    xq_h = xq_words.cpu().numpy().view(np.uint32)
    xp_h = xp_words.cpu().numpy().view(np.uint32)
    for k in range(Ns):
        c = C[k].long()
        x = _query_bit(xq_words, k)
        fl, gl = f.long(), g.long()
        uf = torch.where(fl == Mp, c, U[k][fl.clamp(max=Mp - 1)].long())
        ug = torch.where(gl == Mp, c, U[k][gl.clamp(max=Mp - 1)].long())
        f1 = torch.where(x != 0, c + fl - uf, uf)
        g1 = torch.where(x != 0, c + gl - ug, ug)
        coll = torch.nonzero(g1 <= f1).flatten().tolist()
        if coll:
            dk = D[k].cpu().numpy()
            ak = A[k + 1].cpu().numpy()
            e_h, f_h, g_h = e.tolist(), f.tolist(), g.tolist()
            f1_h, g1_h = f1.tolist(), g1.tolist()
            for q in coll:
                recs.append((k, q, e_h[q], f_h[q], g_h[q]))
                e_h[q], f_h[q], g_h[q] = _reset(
                    k, f1_h[q], g1_h[q], dk, ak, xq_h[q], xp_h, Mp, nw)
            e, f, g = (torch.tensor(v, dtype=torch.int32, device=U.device)
                       for v in (e_h, f_h, g_h))
            keep = ~(g1 <= f1)
            f = torch.where(keep, f1.to(torch.int32), f)
            g = torch.where(keep, g1.to(torch.int32), g)
        else:
            f, g = f1.to(torch.int32), g1.to(torch.int32)
    if recs:
        n = min(len(recs), cap)
        rec[:n] = torch.tensor(recs[:n], dtype=torch.int32)
    nrec = torch.tensor([len(recs)], dtype=torch.int32, device=U.device)
    return e, f, g, rec, nrec


def _reset(k, f1, g1, dk, ak, xq, xp, Mp, nw):
    """The reference's post-collapse reset (pbwtMatch.c:309-320) of one
    query; returns the new (e, f, g)."""
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


def match_scan_indexed(U, D, A, C, xq_words, xp_words, e, f, g, cap: int):
    """Query scan against a stored trajectory (kernel K3).

    U, D (Ns, Mp), A (Ns+1, Mp), C (Ns,) from :func:`panel_trajectory`;
    xq_words (Q, nw) and xp_words (Mp, nw) row words with nw*32 >= Ns;
    e, f, g (Q,) the starting intervals. Returns (e, f, g) after the last
    site (the flush carry), rec (cap, 5) int32 records (k, q, e, f, g) of the
    interval before each collapse, and nrec (1,): the number of collapses.
    nrec > cap means the buffer overflowed and the scan must run again with
    a larger cap. The kernel appends records in no fixed order.
    """
    if U.device.type == "cpu":
        return match_scan_indexed_plain(U, D, A, C, xq_words, xp_words,
                                        e, f, g, cap)
    dev = kernels.cuda_tensors(U, D, A, C, xq_words, xp_words, e, f, g)
    Ns, Mp = U.shape
    Q, nw = xq_words.shape
    if (nw * 32 < Ns or A.shape != (Ns + 1, Mp) or D.shape != U.shape
            or C.numel() != Ns or xp_words.shape != (Mp, nw)
            or not e.numel() == f.numel() == g.numel() == Q):
        raise ValueError("match_scan_indexed: inconsistent table shapes")
    e, f, g = e.clone(), f.clone(), g.clone()
    rec = torch.full((cap, REC_INTS), -1, dtype=torch.int32, device=dev)
    nrec = torch.zeros(1, dtype=torch.int32, device=dev)
    kernels.launch("k3_match_scan", dev.index, U.data_ptr(), D.data_ptr(),
                   A.data_ptr(), C.data_ptr(), xq_words.data_ptr(),
                   xp_words.data_ptr(), Ns, Mp, Q, nw, e.data_ptr(),
                   f.data_ptr(), g.data_ptr(), rec.data_ptr(), cap,
                   nrec.data_ptr(), kernels.stream(dev))
    return e, f, g, rec, nrec


def sort_records(rec: torch.Tensor, nrec: int, Q: int) -> torch.Tensor:
    """The first nrec records ordered by (site, query)."""
    rec = rec[:nrec]
    return rec[torch.argsort(rec[:, 0].long() * Q + rec[:, 1])]


def expand_rows(A, rec, e, f, g, n_sites: int) -> torch.Tensor:
    """Records (sorted) then the k = N flush -> (n, 4) int32 rows
    (q, haplotype, start, end), each record's haplotypes in interval order.
    The flush rows read the final prefix array A[Ns] and report end =
    n_sites. Flat indices are int64."""
    Ns, Mp = A.shape[0] - 1, A.shape[1]
    Q = e.numel()
    dev = A.device
    k = torch.cat([rec[:, 0].long(),
                   torch.full((Q,), Ns, dtype=torch.long, device=dev)])
    q = torch.cat([rec[:, 1], torch.arange(Q, dtype=torch.int32,
                                           device=dev)])
    start = torch.cat([rec[:, 2], e])
    lo = torch.cat([rec[:, 3], f]).long()
    width = (torch.cat([rec[:, 4], g]).long() - lo).clamp(min=0)
    total = int(width.sum())
    rid = torch.repeat_interleave(torch.arange(width.numel(), device=dev),
                                  width, output_size=total)
    first = torch.cumsum(width, 0) - width
    pos = torch.arange(total, device=dev) - first[rid]
    kr = k[rid]
    ids = A.view(-1)[kr * Mp + lo[rid] + pos]
    end = torch.where(kr == Ns, n_sites, kr).to(torch.int32)
    return torch.stack([q[rid], ids, start[rid], end], 1)


class DeviceMatcher:
    """Standing-panel matcher: the panel's trajectory is built once on the
    device at construction; :meth:`match` serves query batches from it."""

    def __init__(self, Xp: np.ndarray, device=None):
        M, N = Xp.shape
        self._shape_init(M, N, device)
        xp_pad = np.zeros((self.Mp, 4 * self.Ng), np.uint8)
        bits = np.packbits(np.ascontiguousarray(Xp, np.uint8), axis=1)
        xp_pad[:M, :bits.shape[1]] = bits
        xp_pad[M:] = xp_pad[0]
        self._finish_init(torch.from_numpy(xp_pad).to(self.device))

    @classmethod
    def from_pbwt(cls, p, device=None, chunk_sites: int = 512):
        """Build from a packed PBWT, decoding the pack3 stream a chunk of
        sites at a time (O(M * chunk) host bytes) instead of materialising
        the (M, N) haplotype matrix."""
        self = cls.__new__(cls)
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
            out = native.natural_cols(p.yz, nc, M, a, start=pos,
                                      with_pos=True)
            if out is None:                   # no native runtime: dense
                return cls(p.haplotypes(), device=device)
            Xc, a, _, pos = out
            bits = np.packbits(native.transpose_u8(Xc), axis=1)
            pad = np.empty((self.Mp, bits.shape[1]), np.uint8)
            pad[:M] = bits
            pad[M:] = bits[0]
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
        need = 12 * self.Mp * (self.Ng * GROUP + 1)
        if need > TRAJ_BYTES:
            raise ValueError(
                f"panel of {M} x {N} needs {need} bytes of trajectory, over "
                f"the {TRAJ_BYTES}-byte budget; the segmented matcher for "
                f"such panels is not ported yet (use python -m pbwt_tpu)")
        self._caps: dict[int, int] = {}

    def _finish_init(self, xp_pad: torch.Tensor) -> None:
        """Row words, group words and the trajectory from the (Mp, 4*Ng)
        packbits rows on the device."""
        self.xp_words = xp_pad.view(torch.int32)              # (Mp, Ng)
        W = _BITREV.to(self.device)[xp_pad.long()].view(torch.int32) \
            .t().contiguous()                                 # (Ng, Mp)
        a0 = torch.arange(self.Mp, dtype=torch.int32, device=self.device)
        d0 = torch.zeros(self.Mp, dtype=torch.int32, device=self.device)
        d0[0] = 1
        self.A, self.D, self.U, self.C = panel_trajectory(W, a0, d0)

    def match(self, Xq: np.ndarray) -> np.ndarray:
        """Set-maximal matches of the (Q, N) queries: (n, 4) int32 rows
        (q, panel haplotype, start, end) in the JAX matcher's order."""
        Q = Xq.shape[0]
        if Xq.shape[1] != self.N:
            raise ValueError(f"query length {Xq.shape[1]} != panel length "
                             f"{self.N}")
        xq_words = torch.from_numpy(pack_row_words(Xq, self.Ng)) \
            .to(self.device)
        cap = self._caps.get(Q, pow2_at_least(max(REC_CAP, 128 * Q)))
        while True:
            start = (torch.zeros(Q, dtype=torch.int32, device=self.device),
                     torch.zeros(Q, dtype=torch.int32, device=self.device),
                     torch.full((Q,), self.Mp, dtype=torch.int32,
                                device=self.device))
            e, f, g, rec, nrec = match_scan_indexed(
                self.U, self.D, self.A, self.C, xq_words, self.xp_words,
                *start, cap=cap)
            nrec = int(nrec)
            if nrec <= cap:
                break
            cap = pow2_at_least(nrec)          # overflow: run again larger
        self._caps[Q] = cap
        rows = expand_rows(self.A, sort_records(rec, nrec, Q), e, f, g,
                           self.N)
        return rows[rows[:, 1] < self.M].cpu().numpy()
