"""Logging / timing utilities (reference utils.c timeUpdate, logFile)."""

from __future__ import annotations

import resource
import sys

log_file = sys.stderr


def set_log_file(f) -> None:
    global log_file
    log_file = f


def log(msg: str) -> None:
    print(msg, file=log_file)
    log_file.flush()


_is_first = True
_last_user = 0.0
_last_sys = 0.0
_last_rss = 0


def time_update(file=None) -> None:
    """Per-stage resource report — same line shape as the reference's
    timeUpdate (utils.c:173-198): silent on the first call (isFirst), then
    ``user\\t<d>\\tsystem\\t<d>\\tmax_RSS\\t<d>\\tMemory\\t<n>``.  Memory is
    the reference's cumulative counting-allocator total; the closest cheap
    Python analogue is the interpreter's live allocation-block count."""
    global _is_first, _last_user, _last_sys, _last_rss
    file = file or log_file
    ru = resource.getrusage(resource.RUSAGE_SELF)
    if not _is_first:
        print(f"user\t{ru.ru_utime - _last_user:.6f}"
              f"\tsystem\t{ru.ru_stime - _last_sys:.6f}"
              f"\tmax_RSS\t{ru.ru_maxrss - _last_rss}"
              f"\tMemory\t{sys.getallocatedblocks()}", file=file)
        file.flush()
    _is_first = False
    _last_user, _last_sys = ru.ru_utime, ru.ru_stime
    _last_rss = ru.ru_maxrss


def fopen_tag(root: str, tag: str, mode: str):
    """fopenTag (utils.c:80-90): open root.tag."""
    return open(f"{root}.{tag}", mode)


def c_f(v: float, prec: int = 4) -> str:
    """printf("%.Nf") rendering incl. the glibc "-nan" for 0/0 results."""
    import math
    if math.isnan(v):
        return "-nan"
    return f"{v:.{prec}f}"
