"""Host milliseconds a request in ``ops.impute.emit``: the output pass of a
batch's imputed panel, the (T, Nref) results made site-major and the C pass
that gathers, pack3-encodes and run-length codes them (the program's span,
its records in the traced window over the window's requests)."""

from benchmark.metrics._program_spans import window_ms


def read(ctx):
    return window_ms(ctx, "ops.impute.emit")
