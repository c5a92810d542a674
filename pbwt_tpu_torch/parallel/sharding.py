"""Haplotype-sharded PBWT construction over a process group.

Counterpart of ``pbwt_tpu/parallel/sharding.py``. Each rank owns a
contiguous block of B = Mp / world haplotypes in natural order; their group
words never move. What moves is each owned haplotype's position in the
global sort order, one FM step a site (kernel K7, ``ops/sharding.py``),
from the one piece of global state a site: the bit-packed sorted column,
Mp/32 int32 words, the all-reduce of every rank's bits scattered at their
positions (disjoint bits, so the SUM is an OR). K7 scatters the next site's
bits while it steps, into the next site's row, so a site is one K7 call and
one collective, Mp/8 bytes.

The sites run a 32-site group at a time (:class:`SiteGroups`) on buffers
whose addresses never change. On NCCL the group is captured once a build
as a CUDA graph, collectives included, after a first group run directly,
and every later group is one replay: a site costs the host nothing. gloo's
collectives cannot be captured, so there the same function runs directly.

The divergence array is position-indexed and kept replicated: after the
chase every rank holds every sorted column (the build's output), and one
launch of K2 over them (``ops/partition.py:ad_columns``) gives the final
divergence array; no further traffic. The final prefix array is one
all-reduce at the end.

Padding as the JAX package: rows beyond M are all-ones haplotypes, to a
multiple of 32 x world; sites beyond N all-ones (identity FM steps).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import build, kernels
from ..ops.partition import GROUP, ad_columns
from ..ops.sharding import fm_step, prefix_len


class SiteGroups:
    """The FM chase of one rank, a 32-site group at a time.

    W_local: (Ng, B) int32 natural-order group words of the rank's
    haplotypes. The buffers stay where they are from group to group:
    ``pos`` (B,), the rank's positions; ``words`` (2, B), the group's words
    and the next group's; ``stage`` (33, Mp/32), the group's packed columns
    and, in the last row, the next group's first contribution; ``counts``
    (32,); K7's chunk prefix. :meth:`run` copies a group's words in, runs
    :meth:`step` (directly, or as a replay of its captured graph on NCCL)
    and copies the columns and counts out.
    """

    def __init__(self, W_local: torch.Tensor, group):
        Ng, B = W_local.shape
        self.W, self.group = W_local, group
        self.Mp = Mp = B * group.world
        dev, i32 = W_local.device, torch.int32
        self.ids = group.rank * B + torch.arange(B, dtype=i32, device=dev)
        self.pos = self.ids.clone()
        self.words = torch.empty((2, B), dtype=i32, device=dev)
        self.stage = torch.zeros((GROUP + 1, Mp // 32), dtype=i32, device=dev)
        self.counts = torch.empty(GROUP, dtype=i32, device=dev)
        self.pref = torch.empty(prefix_len(Mp), dtype=i32, device=dev)
        self.graph = None
        # the first site's contribution, carried in the last row
        fm_step(self.pos, None, 0, None, Mp, nxt=self.stage[GROUP],
                wn=W_local[0], s_next=0, out=self.pos)

    def step(self) -> None:
        """One group, all on the current stream: the carried contribution
        becomes row 0, the other rows are zeroed; then 32 times the
        all-reduce of a row into the site's column and K7 on it, which
        scatters the next site's bits into the next row (the last site's,
        from the next group's words, into the carried row)."""
        st, Mp = self.stage, self.Mp
        st[0].copy_(st[GROUP])
        st[1:].zero_()
        for s in range(GROUP):
            self.group.all_reduce(st[s])
            fm_step(self.pos, self.words[0], s, st[s], Mp, nxt=st[s + 1],
                    wn=self.words[(s + 1) // GROUP], s_next=(s + 1) % GROUP,
                    count=self.counts[s:s + 1], out=self.pos, pref=self.pref)

    def run(self, g: int, sitewords: torch.Tensor,
            counts: torch.Tensor) -> None:
        """Group g: its columns into sitewords[32g:32g+32], its zero counts
        into counts[32g:32g+32]. The last group scatters into the carried
        row from its own words again; nothing reads that row."""
        self.words[0].copy_(self.W[g])
        self.words[1].copy_(self.W[min(g + 1, len(self.W) - 1)])
        if self.group.backend != "nccl":
            self.step()
        elif self.graph is None:
            self.step()
            nbytes = self.group.bytes
            try:
                self.graph = kernels.Graph("sharded_site_group", self.step)
            finally:
                self.group.bytes = nbytes    # the capture moved nothing
        else:
            self.graph.replay()
            self.group.bytes += GROUP * self.stage[0].numel() * 4
        sitewords[GROUP * g:GROUP * (g + 1)].copy_(self.stage[:GROUP])
        counts[GROUP * g:GROUP * (g + 1)].copy_(self.counts)


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
    d = torch.zeros(Mp, dtype=i32, device=dev)
    if Mp:
        d[0] = 1
    ids = group.rank * B + torch.arange(B, dtype=i32, device=dev)
    if ns == 0:
        return sitewords, counts, group.all_reduce(
            torch.zeros(Mp, dtype=i32, device=dev).scatter_(
                0, ids.long(), ids)), d
    chase = SiteGroups(W_local, group)
    for g in range(Ng):
        chase.run(g, sitewords, counts)
    a_end = torch.zeros(Mp, dtype=i32, device=dev).scatter_(
        0, chase.pos.long(), chase.ids)
    group.all_reduce(a_end)
    if with_divergence:
        d = ad_columns(sitewords, torch.arange(Mp, dtype=i32, device=dev),
                       d)[1]
        if n_sites is not None and n_sites % GROUP:
            # trailing all-ones pad sites only advance the d[0] = k+2
            # sentinel
            d[0] = n_sites + 1
    return sitewords, counts, a_end, d


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
    return (build.encode_columns(sitewords[:N].cpu().numpy(), M),
            a_end[:M].cpu().numpy().astype(np.int32),
            counts[:N].cpu().numpy())
