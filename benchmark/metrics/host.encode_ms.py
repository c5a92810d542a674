"""Host milliseconds a block in ``ops.build.encode_columns`` (pack3 on the C
runtime), from the benchmark's span around it."""


def read(ctx):
    spans = ctx.run.spans.durations.get("host.encode_columns") if ctx.run.spans else None
    if not spans:
        return None
    return 1e3 * sum(spans) / len(ctx.client.requests)
