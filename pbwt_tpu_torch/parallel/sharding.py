"""Haplotype-sharded PBWT construction over a process group.

Counterpart of ``pbwt_tpu/parallel/sharding.py``. Each rank owns a
contiguous block of B = Mp / world haplotypes in natural order; their group
words never move. What moves is each owned haplotype's position in the
global sort order, one FM step a site (kernel K7, ``ops/sharding.py``),
from the one piece of global state a site: the bit-packed sorted column,
Mp/32 int32 words, the all-reduce of every rank's bits scattered at their
positions (disjoint bits, so the SUM is an OR). K7 scatters the next site's
bits while it steps, into that site's row of the output, so a site is one
launch and one collective, Mp/8 bytes.

The divergence array is position-indexed and kept replicated: every rank
runs K2's single-site step (``ops/partition.py:partition_ad_step``) on the
column, which K7 unpacks one position an int32; no further traffic. The
final prefix array is one all-reduce at the end.

Padding as the JAX package: rows beyond M are all-ones haplotypes, to a
multiple of 32 x world; sites beyond N all-ones (identity FM steps).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import native, pack3
from ..ops import build
from ..ops.partition import GROUP, partition_ad_step
from ..ops.sharding import fm_step


def build_scan_sharded_grouped(W_local: torch.Tensor, group,
                               with_divergence: bool = True,
                               n_sites: int | None = None):
    """Sharded construction over 32-site packed-word groups.

    W_local: (Ng, B) int32 natural-order group words of this rank's
    haplotypes, rows group.rank * B .. + B of the (Ng, Mp) words of
    ``ops/build.pack_group_words`` (Mp = B x world, a multiple of 32 x
    world; pad rows and pad sites all ones). Returns (sitewords (Ng*32,
    Mp/32) int32 bit-packed sorted columns, counts (Ng*32,) int32, a_end
    (Mp,) int32, d_end (Mp,) int32), the same on every rank: the
    ``ycols, counts, a_end, d_end`` of ``ops/build.build_scan_grouped``.
    Without divergence d_end is the start array (zeros, d[0] = 1); with it
    and n_sites not a whole number of groups, d_end[0] = n_sites + 1.
    """
    Ng, B = W_local.shape
    Mp = B * group.world
    if Mp % (32 * group.world):
        raise ValueError(f"sharded build: {Mp} rows are not a multiple of "
                         f"32 x {group.world} ranks")
    dev = W_local.device
    ns = Ng * GROUP
    i32 = torch.int32
    sitewords = torch.zeros((ns, Mp // 32), dtype=i32, device=dev)
    counts = torch.empty(ns, dtype=i32, device=dev)
    ids = group.rank * B + torch.arange(B, dtype=i32, device=dev)
    d = torch.zeros(Mp, dtype=i32, device=dev)
    if Mp:
        d[0] = 1
    if ns == 0:
        return sitewords, counts, group.all_reduce(
            torch.zeros(Mp, dtype=i32, device=dev).scatter_(
                0, ids.long(), ids)), d
    pos = ids.clone()
    col = torch.empty(Mp, dtype=i32, device=dev) if with_divergence else None
    a_any = torch.arange(Mp, dtype=i32, device=dev)
    # the first site's contribution; then a site: its column, one step
    fm_step(pos, None, 0, None, Mp, nxt=sitewords[0], wn=W_local[0],
            s_next=0, out=pos)
    for k in range(ns):
        group.all_reduce(sitewords[k])
        nk = k + 1
        nxt = (dict(nxt=sitewords[nk], wn=W_local[nk // GROUP],
                    s_next=nk % GROUP) if nk < ns else {})
        fm_step(pos, W_local[k // GROUP], k % GROUP, sitewords[k], Mp,
                col=col, count=counts[k:k + 1], out=pos, **nxt)
        if with_divergence:
            d = partition_ad_step(a_any, d, col, 0, k)[1]
    a_end = torch.zeros(Mp, dtype=i32, device=dev).scatter_(0, pos.long(),
                                                            ids)
    group.all_reduce(a_end)
    if with_divergence and n_sites is not None and n_sites % GROUP:
        # trailing all-ones pad sites only advance the d[0] = k+2 sentinel
        d[0] = n_sites + 1
    return sitewords, counts, a_end, d


def unpack_words32_host(sitewords: np.ndarray, M: int) -> np.ndarray:
    """(Ns, Mp//32) int32 packed columns -> (Ns, M) uint8 sorted columns."""
    return build.unpack_columns(np.asarray(sitewords), M)


def local_words(X: np.ndarray, group) -> torch.Tensor:
    """This rank's (Ng, B) group words of the (M, N) haplotypes X, the rows
    padded with all-ones haplotypes to a multiple of 32 x world."""
    M = X.shape[0]
    Mp = build.pad_to(M, 32 * group.world)
    B = Mp // group.world
    lo = group.rank * B
    rows = X[lo:min(lo + B, M)]
    W = build.pack_group_words(rows, B)
    return torch.from_numpy(W).to(group.device)


def build_pbwt_sharded(X: np.ndarray, group):
    """End-to-end sharded build from an (M, N) haplotype matrix (each rank
    passes the whole X and packs its own rows); returns (yz bytes, aFend
    int32[M], counts int32[N]) on every rank, byte-identical to the host
    engine."""
    M, N = X.shape
    W = local_words(X, group)
    sitewords, counts, a_end, _ = build_scan_sharded_grouped(
        W, group, with_divergence=False)
    Ysort = unpack_words32_host(sitewords[:N].cpu().numpy(), M)
    yz, _ = native.encode_cols(Ysort) or pack3.pack_columns(Ysort)
    return (yz, a_end[:M].cpu().numpy().astype(np.int32),
            counts[:N].cpu().numpy())
