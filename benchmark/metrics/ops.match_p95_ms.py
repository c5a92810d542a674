"""The 95th percentile, over every request of the traced window, of the
time from a ``DeviceMatcher.match`` call to its rows on the host (host
clock; numpy's linear interpolation between order statistics). A request
is one batch. Between processes this tail spreads more than the window's
rate does, so it is read per layer, beside ``queries_per_s``."""

import numpy as np


def read(ctx):
    reqs = ctx.client.requests
    if not reqs:
        return None
    return 1e3 * float(np.percentile([r.end - r.start for r in reqs], 95))
