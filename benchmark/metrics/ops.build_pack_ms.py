"""Host milliseconds a block in ``ops.build.pack``, the block's columns
packed into K1's group words with numpy (the program's span, its records in
the traced window over the window's blocks)."""

from benchmark.metrics._program_spans import window_ms


def read(ctx):
    return window_ms(ctx, "ops.build.pack")
