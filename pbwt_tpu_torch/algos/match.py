"""Query-vs-panel matching: the device routes of -matchIndexed and
-matchDynamic on the port's DeviceMatcher.

Counterpart of the device branches of ``pbwt_tpu/algos/match.py``
(:354-401 and :499-559). Rows come back in the matcher's (site, query)
order and are re-sorted into each command's report order, so stdout is
byte-identical to the host paths, to which every other case delegates.
"""

from __future__ import annotations

import sys

import numpy as np

from ..host import PBWT, engine, host_match, native, pbwtfile, utils
from ..ops import device_requested
from ..ops.match import DeviceMatcher

report_match_stdout = host_match.report_match_stdout

# panels this small stay on the host, as in the JAX package
DEVICE_MIN_M = 512


def _use_device(p: PBWT) -> bool:
    return device_requested() and p.M > DEVICE_MIN_M


def _matcher(p: PBWT, device) -> DeviceMatcher:
    return (DeviceMatcher.from_pbwt(p, device=device) if p.yz
            else DeviceMatcher(p.haplotypes(), device=device))


def _report_rows(rows: np.ndarray, report) -> None:
    binout = getattr(sys.stdout, "buffer", None)
    if report is report_match_stdout and binout is not None:
        sys.stdout.flush()
        if native.write_match_rows(rows, binout):
            binout.flush()
            return
    for a, b, s, e in rows.tolist():
        report(a, b, s, e)


def match_sequences_indexed(p: PBWT, q: PBWT, report=report_match_stdout,
                            device=None) -> None:
    """-matchIndexed (matchSequencesIndexed, pbwtMatch.c:255-340): every
    set-maximal match of each query, reported by (query, end site)."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    if not _use_device(p):
        host_match.match_sequences_indexed(p, q, report)
        return
    rows = _matcher(p, device).match(q.haplotypes())
    rows = rows[np.lexsort((np.arange(len(rows)), rows[:, 3], rows[:, 0]))]
    events = np.unique(rows[:, [0, 2, 3]], axis=0)
    _report_rows(rows, report)
    n_tot = max(len(events), 1)
    tot_len = int((events[:, 2].astype(np.int64) - events[:, 1]).sum())
    utils.log(f"Average number of best matches {n_tot / q.M:.1f}, "
              f"Average length {tot_len / n_tot:.1f}")


def match_sequences_sweep(p: PBWT, q: PBWT, report, device=None) -> None:
    """-matchDynamic (matchSequencesSweep, pbwtMatch.c:363-443): the same
    match set ordered as the sweep reports it, by end site and within a
    site by the queries' PBWT order (pbwtMatch.c:376)."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    if not _use_device(p):
        host_match.match_sequences_sweep(p, q, report)
        return
    N, QM = p.N, q.M
    rows = _matcher(p, device).match(q.haplotypes())
    Yq = q.decoded(True)
    aq = (q.aFstart if q.aFstart is not None
          else np.arange(QM, dtype=np.int32)).copy()
    qpos = np.empty((N + 1, QM), np.int32)
    for k in range(N):
        qpos[k, aq] = np.arange(QM)
        aq = engine.forwards_a(aq, Yq[k])
    qpos[N, aq] = np.arange(QM)
    rows = rows[np.lexsort((np.arange(len(rows)),
                            qpos[rows[:, 3], rows[:, 0]], rows[:, 3]))]
    _report_rows(rows, report)
    n_tot = len(rows)
    tot_len = int((rows[:, 3].astype(np.int64) - rows[:, 2]).sum())
    utils.log(f"Average number of best matches including alternates "
              f"{n_tot / QM:.1f}, Average length "
              f"{tot_len / max(n_tot, 1):.1f}, Av number per position "
              f"{tot_len / (QM * N):.1f}")


def match_sequences_dynamic(p: PBWT, fp, device=None) -> None:
    q = pbwtfile.read_pbwt(fp)
    match_sequences_sweep(p, q, report_match_stdout, device=device)
