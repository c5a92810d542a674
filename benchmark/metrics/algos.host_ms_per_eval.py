"""Milliseconds of an evaluation that are not K4 on the card: the
evaluator's wall time (each request's host clock) less the ``k4_eval``
kernels' device time in the trace, a mean over the window's evaluations."""


def read(ctx):
    if ctx.trace is None:
        return None
    t, n = ctx.trace.kernel("k4_eval")
    reqs = ctx.client.requests
    if not n:
        return None
    return 1e3 * (sum(r.end - r.start for r in reqs) - t) / len(reqs)
