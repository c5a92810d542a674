"""Haplotype x sites turned into pack3 bytes on the host, over the window's
seconds (host clock)."""


def read(ctx):
    n = ctx.client.total("hap_sites")
    return n / ctx.client.window_s if n else None
