"""K4's share of its roofline, in %: the bound of an evaluation
(rooflines/k4_ls_eval.py: 7 N M^2 f64 operations) times the window's
evaluations, over the summed device time of the ``k4_eval`` kernels in the
trace."""

from benchmark.rooflines import k4_ls_eval as roof


def read(ctx):
    t, n = ctx.trace.kernel("k4_eval") if ctx.trace else (0.0, 0)
    if not n or n != len(ctx.client.requests):
        return None
    s = ctx.run.shapes
    return 100.0 * n * roof.bound(s["M"], s["N"]) / t
