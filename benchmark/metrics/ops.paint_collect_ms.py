"""Host milliseconds a request in ``ops.paint.collect``: the host C
runtime's scan of the panel's within-panel matches into per-recipient
buckets (the program's span, its records in the traced window over the
window's requests)."""

from benchmark.metrics._program_spans import window_ms


def read(ctx):
    return window_ms(ctx, "ops.paint.collect")
