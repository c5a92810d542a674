"""Query-vs-panel matching throughput of the port on one CUDA card, with the
panel standing and cold.

Counterpart of the root ``bench_match.py``. Prints two JSON lines:
``match_queries_per_s`` (``DeviceMatcher.match`` on a panel whose
trajectory was built beforehand) and ``match_queries_per_s_cold_panel``
(``ops/match.match_queries_device``: upload, trajectory, rank plane, scan and
expansion every call), each the median of ``bench.REPS`` runs after one
warm-up with the slowest and fastest beside it, on ``bench.bench_match_data``.

    python -m pbwt_tpu_torch.bench_match [M] [N] [Q]

Without a CUDA card it says so on stderr and exits non-zero before printing
anything.
"""

from __future__ import annotations

import sys

from .bench import (REPS, bench_match_data, card_device, card_record, emit,
                    rate, seconds, timed)
from .ops import match


def main(argv=None) -> int:
    dev = card_device("pbwt_tpu_torch.bench_match")
    argv = sys.argv[1:] if argv is None else argv
    M = int(argv[0]) if len(argv) > 0 else 100_000
    N = int(argv[1]) if len(argv) > 1 else 2048
    Q = int(argv[2]) if len(argv) > 2 else 256
    record = card_record(dev)
    Xp, Xq = bench_match_data(M, N, Q)

    def line(metric, secs, rows):
        emit({"metric": metric, **rate("value", Q, secs),
              "unit": "queries/s", "M": M, "N": N, "Q": Q, "rows": rows,
              **seconds("seconds", secs), "reps": REPS, **record})

    m = match.DeviceMatcher(Xp, device=dev)
    line("match_queries_per_s", timed(lambda: m.match(Xq)),
         len(m.match(Xq)))
    del m
    secs = timed(lambda: match.match_queries_device(Xp, Xq, device=dev))
    line("match_queries_per_s_cold_panel", secs,
         len(match.match_queries_device(Xp, Xq, device=dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
