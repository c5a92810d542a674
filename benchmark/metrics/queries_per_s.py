"""Query haplotypes whose rows reached the host, over the window's seconds
(host clock, every request of the window)."""


def read(ctx):
    n = ctx.client.total("queries")
    return n / ctx.client.window_s if n else None
