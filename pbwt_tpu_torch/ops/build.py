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

from ..core import native, pack3
from . import resolve_device
from .partition import GROUP, group_scan


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


def unpack_columns(ycols: np.ndarray, M: int) -> np.ndarray:
    """(N, ceil(Mp/32)) packed sorted columns (row i at bit i % 32 of word
    i // 32) -> (N, M) uint8."""
    y = np.ascontiguousarray(ycols).view(np.uint8)
    return np.unpackbits(y, axis=1, bitorder="little")[:, :M]


def build_scan_grouped(W: torch.Tensor, a0: torch.Tensor):
    """Grouped construction over packed words.

    W: (Ng, Mp) int32 group words in natural order; a0: (Mp,) int32 start
    prefix array. Returns (ycols (Ng*32, ceil(Mp/32)) int32 packed sorted
    columns, counts (Ng*32,) int32, a_end (Mp,) int32). On the card all
    groups are one launch of kernel K1.
    """
    return group_scan(W, a0)


def build_pbwt_device(X: np.ndarray, device=None):
    """Construction from an (M, N) haplotype matrix on ``device``.

    Returns (yz bytes, aFend int32[M], counts int32[N]), the contract of
    ``pbwt_tpu.ops.build.build_pbwt_device``.
    """
    dev = resolve_device(device)
    M, N = X.shape
    Mp = pad_to(M)
    W = torch.from_numpy(pack_group_words(X, Mp)).to(dev)
    a0 = torch.arange(Mp, dtype=torch.int32, device=dev)
    ycols, counts, a_end = build_scan_grouped(W, a0)
    Ysort = unpack_columns(ycols[:N].cpu().numpy(), M)
    # the native column encoder when the C runtime is there (its absence
    # comes with a warning): numpy's pack_columns spends most of its time in
    # np.unique at this size
    yz, _ = native.encode_cols(Ysort) or pack3.pack_columns(Ysort)
    return (yz, a_end[:M].cpu().numpy().astype(np.int32),
            counts[:N].cpu().numpy())
