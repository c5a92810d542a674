"""Reduction of a traced window (``torch.profiler``'s events) to the device's
busy time, each kernel's time by name, and the breakdown of the result line.

The window is the host's: from the first ``request`` span's start to the
last one's end. The device is busy where a kernel, a copy or a memset runs
on it (the union of their intervals inside the window); an idle gap is a
stretch of the window with none, named by the innermost host span or
operation that was open at its middle, or ``between requests``.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

from torch.autograd import DeviceType

DEVICE_ACTIVITIES = {"kernel", "gpu_memcpy", "gpu_memset"}
TOP = 10


def _on_device(e) -> bool:
    if e.device_type != DeviceType.CUDA or e.is_user_annotation:
        return False
    kind = getattr(e, "activity_type", None)
    return not kind or kind in DEVICE_ACTIVITIES


class Trace:
    def __init__(self, events):
        host, dev = [], []
        for e in events:
            iv = (e.time_range.start, e.time_range.end, e.name)
            if _on_device(e):
                dev.append(iv)
            elif e.device_type == DeviceType.CPU:
                host.append(iv)
        req = [h for h in host if h[2] == "request"]
        t0, t1 = min(h[0] for h in req), max(h[1] for h in req)
        self.window_s = (t1 - t0) * 1e-6
        self.kernels = [(s, e, n) for s, e, n in dev if e > t0 and s < t1]
        busy, gaps, at = 0.0, [], t0
        for s, e, _ in sorted(self.kernels):
            s, e = max(s, t0), min(e, t1)
            if s > at:
                gaps.append((at, s))
            if e > at:
                busy += e - max(s, at)
                at = e
        if at < t1:
            gaps.append((at, t1))
        self.busy_s = busy * 1e-6
        by_op = defaultdict(float)
        for s, e, n in self.kernels:
            by_op[n] += (min(e, t1) - max(s, t0)) * 1e-6
        self.device_ops = [[n, v] for n, v in
                           sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]]
        by_host = defaultdict(float)
        for (s, e), name in zip(gaps, _innermost(host, gaps)):
            by_host[name] += (e - s) * 1e-6
        self.idle_gaps = [[n, v] for n, v in
                          sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]]

    def kernel(self, part: str) -> tuple[float, int]:
        """(seconds, launches) of the window's kernels whose name holds
        ``part``."""
        hits = [e - s for s, e, n in self.kernels if part in n]
        return sum(hits) * 1e-6, len(hits)


def _innermost(host, gaps):
    """For each gap, the name of the shortest host interval open at its
    middle."""
    events = sorted(host)
    order = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    names = ["between requests"] * len(gaps)
    active, j = [], 0
    for i in order:
        mid = (gaps[i][0] + gaps[i][1]) / 2
        while j < len(events) and events[j][0] <= mid:
            s, e, n = events[j]
            heapq.heappush(active, (e, e - s, n))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        open_ = [a for a in active if a[0] >= mid]
        if open_:
            names[i] = min(open_, key=lambda a: a[1])[2]
    return names
