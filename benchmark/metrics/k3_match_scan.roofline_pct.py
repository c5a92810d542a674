"""K3's share of its roofline, in %: the bound of every scan of the traced
window (rooflines/k3_match_scan.py, with each scan's record count as the
program returned it) over the summed device time of the ``k3_scan``
kernels in the profiler's trace."""

from benchmark.rooflines import k3_match_scan as roof


def read(ctx):
    recs = ctx.run.spans.counters.get("k3.records", [])
    t, n = ctx.trace.kernel("k3_scan") if ctx.trace else (0.0, 0)
    if not n or n != len(recs):
        return None
    s = ctx.run.shapes
    bound = sum(roof.bound(s["M"], s["N"], s["Q"], int(r)) for r in recs)
    return 100.0 * bound / t
