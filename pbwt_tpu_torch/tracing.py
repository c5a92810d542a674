"""Spans and counters at the port's layer boundaries.

``with span(name):`` times one call of a stretch of work on the host clock
(``time.perf_counter``), and ``count(name, n)`` adds n to a counter. What is
kept:

* always, for the life of the process: per span name its calls, seconds,
  self seconds (the seconds less those of its child spans on the same
  thread) and root seconds (those of its calls that were outermost on their
  thread), read by :func:`totals`; per counter its sum, read by
  :func:`counters`;
* while a ``torch.profiler`` is running, and only then: each span is also a
  ``record_function`` of its name, so that it lies in the profiler's
  timeline beside the card's activities, and each call leaves a
  :class:`Record` in :data:`RECORDS`, with its parent's identifier and its
  outermost span's, which every span of one request shares.

Nothing else turns the records on: a traced run or ``-profile`` does it by
running a profiler. A span adds no synchronisation: each wraps work, or a
wait, that the untraced path has anyway. With no profiler running a span is
two clock reads, the profiler's check and a few list and dictionary updates
on the thread's own state, about a microsecond.
"""

from __future__ import annotations

import itertools
import threading
from time import perf_counter
from typing import NamedTuple

import torch
from torch.autograd import _profiler_enabled


class Record(NamedTuple):
    """One call of a span made while a profiler ran (perf_counter seconds)."""
    id: int
    name: str
    t0: float
    t1: float
    self_s: float                   # t1 - t0 less the children's spans
    parent: int | None              # the enclosing span's id
    root: int                       # the outermost span's id

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Total(NamedTuple):
    calls: int
    seconds: float
    self_s: float
    root_s: float                   # seconds of the outermost calls


# the calls made while a profiler ran, in the order they closed
RECORDS: list[Record] = []

_ids = itertools.count(1)
_threads: list = []                 # every thread's (totals, counters)
_threads_lock = threading.Lock()


class _Thread(threading.local):
    """A thread's open spans and its own totals and counters: the spans
    update them without a lock; readers sum over the threads."""

    def __init__(self):
        self.open: list[span] = []
        self.totals: dict[str, list] = {}    # name -> the fields of Total
        self.counters: dict[str, int | float] = {}
        with _threads_lock:
            _threads.append((self.totals, self.counters))


_local = _Thread()


class span:
    """Context manager: one call of the span ``name``."""
    __slots__ = ("name", "t0", "inner", "rf", "id", "root")

    def __init__(self, name: str):
        self.name = name
        self.inner = 0.0

    def __enter__(self) -> "span":
        stack = _local.open
        if _profiler_enabled():
            self._open_record(stack[-1] if stack else None)
        else:
            self.rf = None
        stack.append(self)
        self.t0 = perf_counter()
        return self

    def _open_record(self, parent) -> None:
        self.id = next(_ids)
        # a parent opened before the profiler started has no record
        self.root = getattr(parent, "root", self.id)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()

    def __exit__(self, *exc) -> None:
        t1 = perf_counter()
        dur = t1 - self.t0
        local = _local
        stack = local.open
        stack.pop()
        tot = local.totals.get(self.name)
        if tot is None:
            tot = local.totals[self.name] = [0, 0.0, 0.0, 0.0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.inner
        if stack:
            stack[-1].inner += dur
        else:
            tot[3] += dur
        if self.rf is not None:
            self.rf.__exit__(*exc)
            parent = getattr(stack[-1], "id", None) if stack else None
            RECORDS.append(Record(self.id, self.name, self.t0, t1,
                                  dur - self.inner, parent, self.root))


def count(name: str, n: int | float = 1) -> None:
    """Add n to the counter ``name``."""
    c = _local.counters
    c[name] = c.get(name, 0) + n


def totals() -> dict[str, Total]:
    """Span name -> its :class:`Total` over every thread."""
    out: dict[str, list] = {}
    with _threads_lock:
        for tot, _ in _threads:
            for name, t in list(tot.items()):
                s = out.setdefault(name, [0, 0.0, 0.0, 0.0])
                for i in range(4):
                    s[i] += t[i]
    return {name: Total(*s) for name, s in sorted(out.items())}


def counters() -> dict[str, int | float]:
    """Counter name -> its sum over every thread."""
    out: dict[str, int | float] = {}
    with _threads_lock:
        for _, cnt in _threads:
            for name, v in list(cnt.items()):
                out[name] = out.get(name, 0) + v
    return dict(sorted(out.items()))


def reset() -> None:
    """Forget every total, counter and record (with no span open)."""
    with _threads_lock:
        for tot, cnt in _threads:
            tot.clear()
            cnt.clear()
    RECORDS.clear()


def records(name: str | None = None, t0: float = float("-inf"),
            t1: float = float("inf")) -> list[Record]:
    """The records (of the span ``name``, if given) that opened at or after
    t0 and closed at or before t1."""
    return [r for r in list(RECORDS) if (name is None or r.name == name)
            and r.t0 >= t0 and r.t1 <= t1]


def write_tsv(path: str) -> None:
    """The totals as tab-separated lines after a header: ``span``, the
    name, calls, seconds and self seconds, a line a span name; then
    ``counter``, the name and its sum, a line a counter."""
    with open(path, "w") as f:
        f.write("kind\tname\tcalls\tseconds\tself_seconds\n")
        for name, t in totals().items():
            f.write(f"span\t{name}\t{t.calls}\t{t.seconds:.6f}\t"
                    f"{t.self_s:.6f}\n")
        for name, v in counters().items():
            f.write(f"counter\t{name}\t{v}\n")
