"""Device PBWT construction on the group-partition kernel (K1).

Counterpart of ``pbwt_tpu/ops/build.py:139-288``. The panel rides as 32
future sites per int32 word; one launch of the kernel runs the 32 stable
partitions of every group, the words aligned to the sort order with a
gather where a group begins, and emits each site's sorted column packed 32
rows per word and its zero count. Kernel ``k1_encode_columns`` pack3-encodes
the packed sorted columns where they lie into the byte-exact .pbwt stream,
and only its bytes cross to the host; ``k1_decode_columns`` turns such a
stream back into packed sorted columns on the card.

Padding (as the JAX package): rows beyond M are all-ones haplotypes, which
start at the end of the sort order and stay there under every stable
partition, and sites beyond N are all-ones columns, which leave the order
unchanged; so the first M entries of every output are the unpadded result.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from . import kernels, resolve_device
from .impute import _pack3_bytes
from .partition import GROUP, ad_trajectory, group_scan

DIVERGENCE_BYTES = 2 << 30     # trajectory tables of one chunk of the
                               # divergence pass


def pad_to(M: int, multiple: int = 256) -> int:
    return -(-M // multiple) * multiple


def pack_group_words(X: np.ndarray, Mp: int) -> np.ndarray:
    """(M, N) 0/1 haplotypes -> (ceil(N/32), Mp) int32 group words: site
    32t+s of haplotype i at bit s of word [t, i]. Rows M..Mp-1 and sites
    beyond N are ones. Packs along each haplotype's row, so the (N, Mp)
    column matrix of the JAX package's prepare_columns is never formed."""
    M, N = X.shape
    Ng = -(-N // GROUP)
    bits = np.packbits(np.ascontiguousarray(X, np.uint8), axis=1,
                       bitorder="little")           # site 8j+b: byte j, bit b
    rows = np.full((Mp, 4 * Ng), 0xFF, np.uint8)
    rows[:M, :bits.shape[1]] = bits
    if N % 8:                                       # ones past N in the byte
        rows[:M, bits.shape[1] - 1] |= np.uint8((0xFF << (N % 8)) & 0xFF)
    return np.ascontiguousarray(rows.view(np.int32).T)


def pack_column_words(cols: np.ndarray, Mp: int) -> np.ndarray:
    """(n, M) 0/1 natural-order columns -> (ceil(n/32), Mp) int32 group
    words, the layout of :func:`pack_group_words` (site 32t+s of haplotype
    i at bit s of word [t, i]; rows M..Mp-1 and sites beyond n ones), packed
    along the columns so that a stream of columns needs no transpose."""
    n, M = cols.shape
    Ng, full = -(-n // GROUP), n // GROUP
    W = np.full((Ng, Mp), -1, np.int32)
    if full:
        b = np.packbits(cols[:full * GROUP].reshape(full, GROUP, M), axis=1,
                        bitorder="little")          # site 8j+b: byte j, bit b
        W[:full, :M] = np.ascontiguousarray(b.transpose(0, 2, 1)).view(
            np.int32)[..., 0]
    if n % GROUP:
        tail = np.ones((GROUP, M), np.uint8)
        tail[:n % GROUP] = cols[full * GROUP:]
        b = np.packbits(tail, axis=0, bitorder="little")
        W[full, :M] = np.ascontiguousarray(b.T).view(np.int32)[:, 0]
    return W


def pack_columns_plain(cols: torch.Tensor, Mp: int) -> torch.Tensor:
    """Plain twin of :func:`pack_columns`."""
    n, M = cols.shape
    bits = torch.ones((-(-n // GROUP) * GROUP, Mp), dtype=torch.int64,
                      device=cols.device)
    bits[:n, :M] = cols != 0
    shifts = torch.arange(GROUP, dtype=torch.int64, device=cols.device)
    v = (bits.view(-1, GROUP, Mp) << shifts[:, None]).sum(1)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def pack_columns(cols: torch.Tensor, Mp: int) -> torch.Tensor:
    """(n, M) uint8 natural-order columns -> (ceil(n/32), Mp) int32 group
    words, the words of :func:`pack_column_words` (a byte counts as 1 when
    it is not 0): kernel ``k1_pack_columns`` on a CUDA tensor, the plain
    twin on a CPU one."""
    if cols.device.type == "cpu":
        return pack_columns_plain(cols, Mp)
    dev = kernels.typed_cuda_tensors((cols, torch.uint8))
    n, M = cols.shape
    if Mp < M:
        raise ValueError(f"pack_columns: {M} columns do not fit {Mp} rows")
    W = torch.empty((-(-n // GROUP), Mp), dtype=torch.int32, device=dev)
    if W.numel():
        kernels.launch("k1_pack_columns", dev.index, cols.data_ptr(), n, M,
                       W.data_ptr(), Mp, kernels.stream(dev))
    return W


def unpack_columns(ycols: np.ndarray, M: int) -> np.ndarray:
    """(N, ceil(Mp/32)) packed sorted columns (row i at bit i % 32 of word
    i // 32) -> (N, M) uint8."""
    y = np.ascontiguousarray(ycols).view(np.uint8)
    return np.unpackbits(y, axis=1, bitorder="little")[:, :M]


def _divergence_end(W: torch.Tensor, a0: torch.Tensor) -> torch.Tensor:
    """The divergence array after the last site of W, from the start array
    (zeros, d[0] = 1): kernel K2 over chunks of whole groups whose
    trajectory tables fit DIVERGENCE_BYTES, one launch a chunk, (a, d) and
    the site number carried from chunk to chunk and the tables reused."""
    Ng, Mp = W.shape
    d = torch.zeros(Mp, dtype=torch.int32, device=W.device)
    d[0] = 1
    if Ng == 0 or Mp == 0:
        return d
    per_group = 12 * Mp * GROUP
    gc = min(max((DIVERGENCE_BYTES - 12 * Mp) // per_group, 1), Ng)
    ns = gc * GROUP
    A = torch.empty((ns + 1, Mp), dtype=torch.int32, device=W.device)
    D, U = (torch.empty((ns, Mp), dtype=torch.int32, device=W.device)
            for _ in "du")
    C = torch.empty(ns, dtype=torch.int32, device=W.device)
    a = a0
    for g0 in range(0, Ng, gc):
        n = (min(g0 + gc, Ng) - g0) * GROUP
        ad_trajectory(W[g0:g0 + gc], a, d, g0 * GROUP,
                      (A[:n + 1], D[:n], U[:n], C[:n]))
        a, d = A[n].clone(), D[n - 1].clone()
    return d


def build_scan_grouped(W: torch.Tensor, a0: torch.Tensor,
                       with_divergence: bool = False,
                       n_sites: int | None = None):
    """Grouped construction over packed words.

    W: (Ng, Mp) int32 group words in natural order; a0: (Mp,) int32 start
    prefix array. Returns (ycols (Ng*32, ceil(Mp/32)) int32 packed sorted
    columns, counts (Ng*32,) int32, a_end (Mp,) int32, d_end (Mp,) int32).
    On the card all groups are one launch of kernel K1. Without divergence
    d_end is the start array (zeros, d[0] = 1) and nothing more runs; with
    it, kernel K2 carries the divergence array through the same sites
    (:func:`_divergence_end`), and where n_sites is given and is not a whole
    number of groups, d_end[0] is n_sites + 1, the value after the last real
    site: the all-ones pad sites only advance that sentinel.
    """
    ycols, counts, a_end = group_scan(W, a0)
    if not with_divergence:
        d_end = torch.zeros_like(a0)
        if d_end.numel():
            d_end[0] = 1
        return ycols, counts, a_end, d_end
    d_end = _divergence_end(W, a0)
    if n_sites is not None and n_sites % GROUP:
        d_end[0] = n_sites + 1
    return ycols, counts, a_end, d_end


def encode_columns_plain(ycols: torch.Tensor, M: int) -> torch.Tensor:
    """Plain twin of :func:`encode_columns`, from the packed words as the
    kernel works: the rows where runs start are the bits of each word XORed
    with itself shifted up one row, the word below's top bit carried in (row
    0 starts each site's first run), a run ends where the next starts or at
    row M, and its bytes follow emit_run's tiers. Returns the pack3 bytes,
    uint8 on ycols' device."""
    n = ycols.shape[0]
    nw = -(-M // GROUP)
    if not n or not M:
        return torch.empty(0, dtype=torch.uint8, device=ycols.device)
    w = ycols[:, :nw].long() & 0xFFFFFFFF
    below = torch.cat((w[:, :1] & 1, w[:, :-1] >> 31), 1)
    s = w ^ (((w << 1) & 0xFFFFFFFF) | below)
    s[:, 0] |= 1
    bit = torch.arange(GROUP, device=ycols.device)
    starts = ((s[:, :, None] >> bit) & 1).view(n, nw * GROUP)[:, :M]
    site, row = torch.nonzero(starts, as_tuple=True)
    at = site * M + row
    length = torch.diff(at, append=at.new_tensor([n * M]))
    sym = (w[site, row // GROUP] >> (row % GROUP)) & 1
    vals, reps = _pack3_bytes(sym, length)
    return torch.repeat_interleave(vals.flatten(), reps.flatten()).to(
        torch.uint8)


def encode_columns(ycols: torch.Tensor, M: int) -> bytes:
    """pack3 bytes of packed sorted columns: ycols (n, ceil(Mp/32)) int32,
    a site a row, row i at bit i % 32 of word i // 32; rows M and on are
    not encoded. On a CUDA tensor kernel ``k1_encode_columns`` (a counting
    pass, the offsets as a scan over the sites, a writing pass) and only the
    bytes cross to the host, in one copy into pinned memory (PyTorch's
    caching host allocator keeps the buffer from call to call); on a CPU
    tensor the plain twin. The yz bytes' copy to the host is the span
    ``ops.build.download``. The bytes of the host C runtime's column
    encoder (``native.encode_cols``) on the unpacked columns."""
    if not len(ycols) or not M:
        return b""
    if ycols.device.type == "cpu":
        yz = encode_columns_plain(ycols, M)
    else:
        dev = kernels.cuda_tensors(ycols)
        n, rw = ycols.shape
        counts = torch.empty(n, dtype=torch.int32, device=dev)
        args = (dev.index, ycols.data_ptr(), n, rw, M, counts.data_ptr())
        kernels.launch("k1_encode_columns", *args, None, None,
                       kernels.stream(dev))
        ends = torch.cumsum(counts, 0, dtype=torch.int64)
        offsets = ends - counts
        yz = torch.empty(int(ends[-1]), dtype=torch.uint8, device=dev)
        kernels.launch("k1_encode_columns", *args, offsets.data_ptr(),
                       yz.data_ptr(), kernels.stream(dev))
    with tracing.span("ops.build.download"):
        if yz.is_cuda:
            yz = torch.empty(yz.numel(), dtype=torch.uint8,
                             pin_memory=True).copy_(yz)
        return yz.numpy().tobytes()


def _byte_rows(yz: torch.Tensor) -> torch.Tensor:
    """The rows each pack3 byte codes (p3dec of the host C runtime), int64:
    b, (b - 64) << 6 and (b - 96) << 11 of its low seven bits."""
    b = (yz & 0x7F).long()
    return torch.where(b < 64, b, torch.where(b < 96, (b - 64) << 6,
                                              (b - 96) << 11))


def _malformed(N: int, M: int) -> ValueError:
    return ValueError(f"decode_columns: the pack3 stream is not {N} sites "
                      f"of {M} rows")


def decode_columns_plain(yz: torch.Tensor, N: int, M: int) -> torch.Tensor:
    """Plain twin of :func:`decode_columns`, by each byte's first row as
    the kernel finds it: the exclusive sums of the bytes' rows give its
    site and row; the bytes of the N sites' rows are run out into a byte a
    row and packed 32 rows a word."""
    dev = yz.device
    rw, total = -(-M // GROUP), N * M
    n = _byte_rows(yz)
    first = torch.cumsum(n, 0) - n
    within = first < total
    if total and (not yz.numel() or int(first[-1] + n[-1]) < total or bool(
            (within & ((first % M) + n > M)).any())):
        raise _malformed(N, M)
    rows = torch.zeros((N, rw * GROUP), dtype=torch.int64, device=dev)
    if total:
        rows[:, :M] = torch.repeat_interleave(
            (yz[within] >> 7).long(), n[within]).view(N, M)
    shifts = torch.arange(GROUP, dtype=torch.int64, device=dev)
    v = (rows.view(N, rw, GROUP) << shifts).sum(2)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def decode_columns(yz: torch.Tensor, N: int, M: int) -> torch.Tensor:
    """The packed sorted columns of the first N sites of a pack3 stream of M
    rows a site, the inverse of :func:`encode_columns`: (N, ceil(M/32))
    int32, row i of a site at bit i % 32 of word i // 32 (rows M and on 0).
    yz: the stream's bytes, a uint8 tensor. On a CUDA tensor kernel
    ``k1_decode_columns`` (a pass of each byte's rows, their exclusive sums
    as a scan over the bytes, a pass that writes the ones runs); on a CPU
    tensor the plain twin. Raises ValueError, as the host C runtime's
    ``p3_decode_cols`` returns -1, where the stream is not N sites of M rows
    (a run across a site's end, or too few bytes); bytes past them are not
    read."""
    if yz.device.type == "cpu":
        return decode_columns_plain(yz, N, M)
    dev = yz.device
    if yz.dtype != torch.uint8 or not yz.is_contiguous():
        raise ValueError("decode_columns: wanted contiguous uint8 bytes")
    nz, rw = yz.numel(), -(-M // GROUP)
    ycols = torch.zeros((N, rw), dtype=torch.int32, device=dev)
    if not N * M:
        return ycols
    if not nz:
        raise _malformed(N, M)
    rows = torch.empty(nz, dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    args = (dev.index, yz.data_ptr(), nz, N, M, rw, rows.data_ptr())
    kernels.launch("k1_decode_columns", *args, None, None, None,
                   kernels.stream(dev))
    first = torch.cumsum(rows, 0, dtype=torch.int64) - rows
    kernels.launch("k1_decode_columns", *args, first.data_ptr(),
                   ycols.data_ptr(), err.data_ptr(), kernels.stream(dev))
    if int(err):
        raise _malformed(N, M)
    return ycols


class BlockBuild:
    """Construction of a stream of natural-order columns on ``device`` in
    blocks of whole 32-site groups (the last block may end inside a group):
    a block's bytes uploaded as they are and packed into group words there
    (:func:`pack_columns`), K1 over the words, the prefix array carried on
    the card from block to block, each block's sorted columns pack3-encoded
    there (:func:`encode_columns`) and only the bytes brought back. The host
    holds one block's columns and the encoded bytes, never the panel.

    ``add(cols)`` takes an (n, M) uint8 block; ``finish()`` returns (yz
    bytes, aFend int32[M]), those of :func:`build_pbwt_device` on the whole
    panel. An ``add`` is the span ``ops.build.add``, its stages its children
    (:mod:`pbwt_tpu_torch.tracing`); ``ops.build.card_packs`` and
    ``ops.build.card_encodes`` count the blocks packed and encoded by the
    kernels.
    """

    def __init__(self, M: int, device=None):
        self.dev = resolve_device(device)
        self.M, self.Mp = M, pad_to(M)
        self.a = torch.arange(self.Mp, dtype=torch.int32, device=self.dev)
        self.yz: list[bytes] = []

    def add(self, cols: np.ndarray) -> None:
        n = len(cols)
        if n == 0:
            return
        with tracing.span("ops.build.add"):
            with tracing.span("ops.build.upload"):
                cols = torch.from_numpy(np.ascontiguousarray(cols, np.uint8))
                cols = cols.to(self.dev)
            with tracing.span("ops.build.pack"):
                W = pack_columns(cols, self.Mp)
            if W.is_cuda:
                tracing.count("ops.build.card_packs")
            with tracing.span("ops.build.scan"):
                ycols, _, self.a, _ = build_scan_grouped(W, self.a)
            if ycols.is_cuda:
                tracing.count("ops.build.card_encodes")
            with tracing.span("ops.build.encode"):
                self.yz.append(encode_columns(ycols[:n], self.M))
        tracing.count("ops.build.sites", n)
        tracing.count("ops.build.hap_sites", n * self.M)
        tracing.count("ops.build.yz_bytes", len(self.yz[-1]))

    def finish(self) -> tuple[bytes, np.ndarray]:
        with tracing.span("ops.build.finish"):
            yz, self.yz = b"".join(self.yz), []
            return yz, self.a[:self.M].cpu().numpy().astype(np.int32)


def build_pbwt_device(X: np.ndarray, device=None, multiple: int = 256):
    """Construction from an (M, N) haplotype matrix on ``device``, the rows
    padded to a multiple of ``multiple``.

    Returns (yz bytes, aFend int32[M], counts int32[N]), the contract of
    ``pbwt_tpu.ops.build.build_pbwt_device``.
    """
    dev = resolve_device(device)
    M, N = X.shape
    Mp = pad_to(M, multiple)
    W = torch.from_numpy(pack_group_words(X, Mp)).to(dev)
    a0 = torch.arange(Mp, dtype=torch.int32, device=dev)
    ycols, counts, a_end, _ = build_scan_grouped(W, a0)
    return (encode_columns(ycols[:N], M),
            a_end[:M].cpu().numpy().astype(np.int32),
            counts[:N].cpu().numpy())
