"""K5's share of its roofline, in %: the bound of every vote of the traced
window (rooflines/k5_impute_vote.py, with each vote's covering pairs as the
cell's hook on ``impute_vote`` counted them from its arguments) over the summed
device time of K5's kernels (its pre-pass ``k5_bounds``, ``k5_window`` and
``k5_vote``, one launch of the entry) in the profiler's trace."""

from benchmark.rooflines import k5_impute_vote as roof


def read(ctx):
    pairs = ctx.run.spans.counters.get("k5.pairs", []) if ctx.run.spans else []
    if not ctx.trace or not pairs:
        return None
    t, _ = ctx.trace.kernel("k5_")
    _, n = ctx.trace.kernel("k5_vote")
    if not n or n != len(pairs):
        return None
    s = ctx.run.shapes
    bound = sum(roof.bound(int(p), s["T"], s["Nref"]) for p in pairs)
    return 100.0 * bound / t
