"""Host milliseconds a request in ``ops.paint.write``: the chunk lengths'
normalisation, the four tables formatted by the host C runtime and written
to their files (the program's span, its records in the traced window over
the window's requests)."""

from benchmark.metrics._program_spans import window_ms


def read(ctx):
    return window_ms(ctx, "ops.paint.write")
