"""The downstream algorithms over a process group: query-sharded matching
and recipient-sharded painting.

Counterpart of ``pbwt_tpu/parallel/query_sharding.py``.

* **Matching** (``match_scan_sharded`` there): queries are independent
  given the panel, so each rank holds the panel's :class:`DeviceMatcher`
  (``ops/match.py``) and matches a contiguous share of the batch. The JAX
  package shards its portable ``match_scan``, a TPU workaround the port does
  not have. Rows travel once: their counts by one all-reduce, then each
  rank's rows by a broadcast. They come back in the single matcher's order,
  which is by (site, query) over the whole batch, not rank after rank.
* **Painting** (``paint_chunks_sharded`` there shards sites): kernel K6 is
  parallel over table cells and a recipient's cells read only its own
  haplotypes' normalisers, so the port shards recipient individuals. Each
  rank runs ``ops/paint.paint_accumulate`` on its individuals' segments (the
  others' ranges empty) and one all-reduce sums the five tables: their rows
  are disjoint and x + 0.0 = x, so the sum is exact, bit for bit the single
  launch's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import shard


def _gather_rows(group, rows: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's (n_r, c) int32 rows, on every rank, in rank order: the
    counts by one all-reduce, then a broadcast a rank (gloo has no all_gather
    of CUDA tensors)."""
    n = torch.zeros(group.world, dtype=torch.int64, device=group.device)
    n[group.rank] = rows.shape[0]
    group.all_reduce(n)
    out = []
    for r, nr in enumerate(n.tolist()):
        buf = (rows.to(group.device).contiguous() if r == group.rank
               else torch.empty((nr, rows.shape[1]), dtype=rows.dtype,
                                device=group.device))
        if nr:
            group.broadcast(buf, r)
        out.append(buf)
    return out


def match_queries_sharded(group, matcher, Xq: np.ndarray) -> np.ndarray:
    """Set-maximal matches of the (Q, N) queries, the batch sharded over
    the group: rank r matches queries [lo_r, hi_r) (``shard``) with its
    matcher, which every rank builds from the same panel. Returns the (n, 4)
    int32 rows (q, panel haplotype, start, end) of ``matcher.match(Xq)``,
    row for row, on every rank.

    ``DeviceMatcher.match`` orders rows by (end, query): each collapse
    record's rows end at its site, and the flush rows, which end at N, come
    last, each record's haplotypes in interval order. A rank's rows keep
    that order, so the ranks' rows, their queries made global, merged by a
    stable sort on (end, query), are the single matcher's rows."""
    Q = Xq.shape[0]
    lo, hi = shard(Q, group.world, group.rank)
    rows = (matcher.match(Xq[lo:hi]) if hi > lo
            else np.zeros((0, 4), np.int32))
    rows = torch.from_numpy(np.ascontiguousarray(rows, np.int32))
    rows[:, 0] += lo
    parts = [t.cpu() for t in _gather_rows(group, rows)]
    allrows = torch.cat(parts).numpy()
    key = allrows[:, 3].astype(np.int64) * max(Q, 1) + allrows[:, 0]
    return allrows[np.argsort(key, kind="stable")]


def paint_tables_sharded(group, sj, ss, se, seg_off, M: int, N: int,
                         ploidy: int, cpr: int):
    """``ops/paint.paint_tables_device`` with the recipient individuals
    sharded over the group, from the host's segment columns (every rank
    passes them all): (counts, totlengths, counts2, counts3, nregions) as
    numpy f64, the same on every rank and bit-equal to the single launch's.
    A rank's share is whole individuals (``shard``)."""
    from ..ops import paint
    if ploidy < 1 or M % ploidy:
        raise ValueError(f"paint_accumulate: {M} haplotypes are not whole "
                         f"individuals of ploidy {ploidy}")
    lo, hi = shard(M, group.world, group.rank, unit=ploidy)
    seg_off = np.asarray(seg_off, np.int64)
    s0, s1 = int(seg_off[lo]), int(seg_off[hi])
    local_off = np.clip(seg_off, s0, s1) - s0
    cols = paint.upload_segments(sj[s0:s1], ss[s0:s1], se[s0:s1], local_off,
                                 group.device)
    tables = paint.paint_accumulate(*cols, M, N, ploidy, cpr)
    for t in tables:
        group.all_reduce(t)
    return paint.download_tables(tables)
