"""K1's share of its roofline, in %: the bound of every block's scan in the
traced window (rooflines/k1_group_partition.py at the block's sites and the
padded rows) over the summed device time of the construction kernel
(``partition_sites``, which only K1 launches in an import) in the trace."""

from benchmark.rooflines import k1_group_partition as roof


def read(ctx):
    t, n = ctx.trace.kernel("partition_sites") if ctx.trace else (0.0, 0)
    reqs = ctx.client.requests
    if not n or n != len(reqs):
        return None
    bound = sum(roof.bound(ctx.run.shapes["Mp"], r.work["sites"]) for r in reqs)
    return 100.0 * bound / t
