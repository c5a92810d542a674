"""Readers of the program's own spans (``pbwt_tpu_torch.tracing``): the
records a span left in the traced window (a profiler runs there, so the
program keeps a record a call), and its totals over the process. Where the
program has no such module or span, each returns None."""


def tracing():
    try:
        from pbwt_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def window_ms(ctx, name: str):
    """Milliseconds a request in the span ``name``: its records that opened
    and closed inside the window, summed, over the window's requests."""
    t, reqs = tracing(), ctx.client.requests
    if t is None or not reqs:
        return None
    recs = t.records(name, ctx.client.start, reqs[-1].end)
    if not recs:
        return None
    return 1e3 * sum(r.seconds for r in recs) / len(reqs)
