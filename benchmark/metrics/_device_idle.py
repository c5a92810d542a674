"""The share of a traced window in which no kernel, copy or memset ran on
the card, from the profiler's timeline (trace.Trace)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.window_s or ctx.run.device.type != "cuda":
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
