"""Host milliseconds a request in ``ops.impute.match``: the frame's
set-maximal matches of a batch of targets, through the standing
``DeviceMatcher`` (its ``ops.match.*`` stages nest inside), rows on the host
(the program's span, its records in the traced window over the window's
requests)."""

from benchmark.metrics._program_spans import window_ms


def read(ctx):
    return window_ms(ctx, "ops.impute.match")
