"""Host milliseconds a batch in ``ops.match.pack_row_words`` (the queries
packed into row words), from the benchmark's span around it."""


def read(ctx):
    spans = ctx.run.spans.durations.get("ops.pack_row_words") if ctx.run.spans else None
    if not spans:
        return None
    return 1e3 * sum(spans) / len(ctx.client.requests)
