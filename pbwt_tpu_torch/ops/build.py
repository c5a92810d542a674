"""Device PBWT construction on the group-partition kernel (K1).

Counterpart of ``pbwt_tpu/ops/build.py:139-288``. The panel rides as 32
future sites per int32 word; one launch of the kernel runs the 32 stable
partitions of every group, the words aligned to the sort order with a
gather where a group begins, and emits each site's sorted column packed 32
rows per word and its zero count. The host pack3-encodes the sorted columns into the byte-exact
.pbwt stream.

Padding (as the JAX package): rows beyond M are all-ones haplotypes, which
start at the end of the sort order and stay there under every stable
partition, and sites beyond N are all-ones columns, which leave the order
unchanged; so the first M entries of every output are the unpadded result.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..core import native
from . import kernels, resolve_device
from .partition import GROUP, ad_trajectory, group_scan

DIVERGENCE_BYTES = 2 << 30     # trajectory tables of one chunk of the
                               # divergence pass
ENCODE_SITES = 1024            # sorted columns unpacked on the host at a time


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


def encode_columns(ycols: np.ndarray, M: int) -> bytes:
    """pack3 bytes of packed sorted columns, ENCODE_SITES columns at a time
    (a column's bytes do not depend on the others'), by the host C
    runtime's column encoder."""
    out = []
    for c0 in range(0, len(ycols), ENCODE_SITES):
        Y = unpack_columns(ycols[c0:c0 + ENCODE_SITES], M)
        out.append(native.encode_cols(Y)[0])      # the C column encoder
    return b"".join(out)


class BlockBuild:
    """Construction of a stream of natural-order columns on ``device`` in
    blocks of whole 32-site groups (the last block may end inside a group):
    a block's bytes uploaded as they are and packed into group words there
    (:func:`pack_columns`), K1 over the words, the prefix array carried on
    the card from block to block, each block's sorted columns pack3-encoded
    as they come back. The host holds one block's columns and the encoded
    bytes, never the panel.

    ``add(cols)`` takes an (n, M) uint8 block; ``finish()`` returns (yz
    bytes, aFend int32[M]), those of :func:`build_pbwt_device` on the whole
    panel. An ``add`` is the span ``ops.build.add``, its stages its children
    (:mod:`pbwt_tpu_torch.tracing`); ``ops.build.card_packs`` counts the
    blocks packed by the kernel.
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
            with tracing.span("ops.build.download"):
                ycols = ycols[:n].cpu().numpy()
            with tracing.span("ops.build.encode"):
                self.yz.append(encode_columns(ycols, self.M))
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
    return (encode_columns(ycols[:N].cpu().numpy(), M),
            a_end[:M].cpu().numpy().astype(np.int32),
            counts[:N].cpu().numpy())
