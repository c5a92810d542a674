"""K6's share of its roofline, in %: the bound of every painting of the
traced window (rooflines/k6_paint_accumulate.py, with each painting's
weighed pairs as the cell's hook on ``paint_accumulate`` counted them from
its arguments) over the summed device time of K6's kernels (``k6_norm``,
the normalisers, and ``k6_cells``, the tables: one launch of the entry) in
the profiler's trace."""

from benchmark.rooflines import k6_paint_accumulate as roof


def read(ctx):
    pairs = ctx.run.spans.counters.get("k6.pairs", []) if ctx.run.spans else []
    if not ctx.trace or not pairs:
        return None
    t, _ = ctx.trace.kernel("k6_")
    _, n = ctx.trace.kernel("k6_cells")
    if not t or n != len(pairs):
        return None
    bound = sum(roof.bound(int(p), M, nseg, ploidy)
                for p, M, nseg, ploidy in pairs)
    return 100.0 * bound / t
