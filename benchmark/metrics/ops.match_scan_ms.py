"""Host milliseconds a batch in ``ops.match.scan``: K3's launch and the wait
for its record count, so K3's time on the card as the host waits for it
(the program's span, its records in the traced window over the window's
batches)."""

from benchmark.metrics._program_spans import window_ms


def read(ctx):
    return window_ms(ctx, "ops.match.scan")
