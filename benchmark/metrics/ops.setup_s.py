"""The program's share of ``setup_s``, in seconds: the time of the
program's outermost spans that closed before the window (its set-up spans,
``setup.*``, and the warm-up calls, which wait for the set-up's work on the
card), from the totals the program keeps over the process less the
outermost spans' records of the traced window."""

from benchmark.metrics._program_spans import tracing


def read(ctx):
    t = tracing()
    if t is None:
        return None
    outermost = sum(tot.root_s for tot in t.totals().values())
    window = sum(r.seconds for r in t.records(t0=ctx.client.start)
                 if r.parent is None)
    before = outermost - window
    return before if before > 0 else None
