"""Host milliseconds a batch in ``ops.match.download``, the rows' copy to
the host (which waits for the card's queued expansion): the program's span,
its records in the traced window over the window's batches."""

from benchmark.metrics._program_spans import window_ms


def read(ctx):
    return window_ms(ctx, "ops.match.download")
