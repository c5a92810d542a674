"""Each kernel's operation and byte count, and the card's published peaks.

A kernel's bound is the larger of its bytes over the card's memory rate and
its operations over its operation rate (``peaks.json``): each input byte
read once, each output byte written once, and the operations that these
inputs need. The counts are copied from ``chip_smoke.py`` (``bound`` at
:316 and the counts at the lines each module cites), where PERF.md's bounds
were computed.
"""

from __future__ import annotations

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "peaks.json")) as _f:
    PEAKS = json.load(_f)


def bound_s(nbytes: float, ops: float, ops_per_s: float | None = None) -> float:
    """The least seconds the card could take to move nbytes and do ops."""
    rate = PEAKS["ops_per_s"] if ops_per_s is None else ops_per_s
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / rate)
