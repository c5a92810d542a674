"""Within-panel matching (-maxWithin, -longWithin) on the host, and
query-vs-panel matching (-matchNaive on the host; -matchIndexed,
-matchDynamic on the host and on the port's DeviceMatcher) (pbwtMatch.c).

Counterpart of ``pbwt_tpu/algos/match.py``. The within-panel matchers are
the host's C scans; painting and -imputeMissing collect their matches from
them. For the query-vs-panel commands the host paths are the numpy and C
ones (-matchNaive and -matchIndexed in numpy, -matchDynamic's sweep in C);
the device routes take
their place when :func:`pbwt_tpu_torch.ops.device_requested` says so and
the panel has more than DEVICE_MIN_M haplotypes. Device rows come back in
the matcher's (site, query) order and are re-sorted into each command's
report order, so stdout is byte-identical to the host paths.

Report rows are printed as "MATCH\\tai\\tbi\\tstart\\tend\\tlen" exactly as
reportMatch (pbwtMatch.c:46-58)."""

from __future__ import annotations

import sys

import numpy as np

from ..core import engine, native, registry
from ..core.pbwt import PBWT
from ..io import pbwtfile
from ..ops import device_requested
from ..utils import log

# panels this small stay on the host
DEVICE_MIN_M = 512


def report_match_stdout(ai: int, bi: int, start: int, end: int) -> None:
    if start == end:
        return
    sys.stdout.write(f"MATCH\t{ai}\t{bi}\t{start}\t{end}\t{end - start}\n")


def check_match_maximal(x: np.ndarray, y: np.ndarray, start: int, end: int, N: int):
    """checkMatchMaximal (pbwtMatch.c:33-44)."""
    if start and x[start - 1] == y[start - 1]:
        raise AssertionError("match not maximal - can extend backwards")
    if end < N and x[end] == y[end]:
        raise AssertionError("match not maximal - can extend forwards")
    if (x[start:end] != y[start:end]).any():
        raise AssertionError("match not a match")


# --------------------------------------------------------------------------
# within-panel matching
# --------------------------------------------------------------------------

def _prev_greater(d: np.ndarray, M: int) -> np.ndarray:
    """g[i] = max j <= i-1 with d[j] > d[i] (scan floor of the up-scan in
    algorithm 4).  Only used for i >= 1; g[0] is set to 0 and never consulted
    because d[0] is the strict-max sentinel so the up-scan never applies at
    i == 0.  O(M) monotonic stack."""
    g = np.zeros(M, dtype=np.int64)
    dl = d.tolist()
    stack = [0]
    for i in range(1, M):
        di = dl[i]
        while dl[stack[-1]] <= di:
            stack.pop()
        g[i] = stack[-1]
        stack.append(i)
    return g


def _next_greater(d: np.ndarray, M: int) -> np.ndarray:
    """h[i] = min j > i+1 with d[j] > d[i+1] (scan ceiling of the down-scan
    in algorithm 4; d[M] is the strict-max sentinel).  h[M-1] unused."""
    h = np.empty(M, dtype=np.int64)
    if M == 0:
        return h
    h[M - 1] = M
    dl = d.tolist()
    stack = [M]
    for t in range(M - 1, 0, -1):
        while dl[stack[-1]] <= dl[t]:
            stack.pop()
        h[t - 1] = stack[-1]
        stack.append(t)
    return h


def match_maximal_within(p: PBWT, report) -> None:
    """Algorithm 4 (matchMaximalWithin, pbwtMatch.c:115-142), the C scan's
    reports in its order."""
    a0 = p.aFstart if p.aFstart is not None else np.arange(p.M, dtype=np.int32)
    # stream the pack3 bytes directly (O(M) live memory); the decoded
    # matrix only when the packed stream is absent
    rows = (native.max_within_packed(p.yz, p.M, p.N, a0) if p.yz
            else native.max_within(p.decoded(True), a0))
    for ai, bi, s, e in rows.tolist():
        report(ai, bi, s, e)


def match_long_within(p: PBWT, T: int, report) -> None:
    """Algorithm 3 variant with starts (matchLongWithin2, pbwtMatch.c:85-113),
    the C scan's reports in its order."""
    a0 = p.aFstart if p.aFstart is not None else np.arange(p.M, dtype=np.int32)
    rows = (native.long_within_packed(p.yz, T, p.M, p.N, a0) if p.yz
            else native.long_within(p.decoded(True), T, a0))
    for ai, bi, s, e in rows.tolist():
        report(ai, bi, s, e)


def max_within_length_hist(p: PBWT) -> dict[int, int]:
    """-stats mode of matchMaximalWithin (pbwtMatch.c:130-131): per unblocked
    row one histogram entry of length k - d[i] (d[i] < d[i+1]) else
    k - d[i+1]; reports are suppressed."""
    Y = p.decoded(True)
    M, N = p.M, p.N
    a = (p.aFstart if p.aFstart is not None else np.arange(M, dtype=np.int32)).copy()
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = 1
    d[M] = 1
    hist: dict[int, int] = {}
    for k in range(N + 1):
        y = Y[k] if k < N else Y[N - 1]
        dm = d
        g = _prev_greater(dm, M)
        h = _next_greater(dm, M)
        c1 = np.zeros(M + 1, dtype=np.int64)
        np.cumsum(y != 0, out=c1[1:])
        c0 = np.arange(M + 1) - c1
        up_applicable = dm[:M] <= dm[1:M + 1]
        down_applicable = dm[:M] >= dm[1:M + 1]
        for i in range(M):
            yi = y[i]
            if k < N:
                if up_applicable[i] and i > g[i]:
                    cnt = (c1[i] - c1[g[i]]) if yi else (c0[i] - c0[g[i]])
                    if cnt > 0:
                        continue
                if down_applicable[i] and h[i] > i + 1:
                    cnt = (c1[h[i]] - c1[i + 1]) if yi else (c0[h[i]] - c0[i + 1])
                    if cnt > 0:
                        continue
            ln = k - int(dm[i]) if dm[i] < dm[i + 1] else k - int(dm[i + 1])
            hist[ln] = hist.get(ln, 0) + 1
        if k < N:
            a, d = engine.forwards_ad(a, d, y, k)
    return hist


def long_matches(p: PBWT, L: int) -> None:
    """pbwtLongMatches (pbwtMatch.c:148-183): CLI driver for -maxWithin /
    -longWithin."""
    if p is None or not p.yz:
        raise ValueError("option -longWithin called without a PBWT")
    if L < 0:
        raise ValueError(f"L {L} for longWithin must be >= 0")

    haps = p.haplotypes() if registry.is_check else None

    def report(ai, bi, start, end):
        if start == end:
            return
        sys.stdout.write(f"MATCH\t{ai}\t{bi}\t{start}\t{end}\t{end - start}\n")
        if haps is not None:
            check_match_maximal(haps[ai], haps[bi], start, end, p.N)

    if registry.is_stats and not L:
        hist = max_within_length_hist(p)
        n_tot = sum(hist.values())
        h_tot = sum(l * c for l, c in hist.items())
        for l in sorted(hist):
            if hist[l]:
                sys.stdout.write(f"{l}\t{hist[l]}\n")
        log(f"Average {n_tot / p.M:.1f} matches per sample")
        log(f"Average length {h_tot / n_tot:.1f}")
        return

    if haps is None and p.yz:
        # stream MATCH lines straight from the C scan to the stdout fd -
        # no row materialisation (13M-row outputs take seconds, not
        # minutes on slow-page-fault hosts)
        a0 = (p.aFstart if p.aFstart is not None
              else np.arange(p.M, dtype=np.int32))
        sys.stdout.flush()
        fd = native._stdout_fd(sys.stdout)
        if fd >= 0:
            if L:
                native.long_within_print(p.yz, L, p.M, p.N, a0, fd)
            else:
                native.max_within_print(p.yz, p.M, p.N, a0, fd)
            return
        binout = getattr(sys.stdout, "buffer", None)
        if binout is not None:
            rows = (native.long_within_packed(p.yz, L, p.M, p.N, a0) if L
                    else native.max_within_packed(p.yz, p.M, p.N, a0))
            native.write_match_rows(rows, binout)
            binout.flush()
            return

    if L:
        match_long_within(p, L, report)
    else:
        match_maximal_within(p, report)


# --------------------------------------------------------------------------
# query-vs-panel matching
# --------------------------------------------------------------------------

def _use_device(p: PBWT) -> bool:
    return device_requested() and p.M > DEVICE_MIN_M


def _matcher(p: PBWT, device):
    """The standing-panel matcher of p: the pack3 panel streams into it
    (O(M * chunk) host bytes) rather than through the dense haplotype
    matrix."""
    from ..ops.match import DeviceMatcher
    return (DeviceMatcher.from_pbwt(p, device=device) if p.yz
            else DeviceMatcher(p.haplotypes(), device=device))


def _report_rows(rows: np.ndarray, report) -> None:
    """Report (n, 4) rows: formatted in C straight to stdout's buffer when
    the report is the stdout one, else row by row."""
    binout = getattr(sys.stdout, "buffer", None)
    if report is report_match_stdout and binout is not None:
        sys.stdout.flush()
        native.write_match_rows(rows, binout)
        binout.flush()
        return
    for a, b, s, e in rows.tolist():
        report(a, b, s, e)


def match_sequences_naive(p: PBWT, q: PBWT, report=report_match_stdout) -> None:
    """O(NMQ) haplotype-space matcher (matchSequencesNaive, pbwtMatch.c:194-248).
    Reports one representative maximal match (lowest reference index)."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    query = q.haplotypes()
    reference = p.haplotypes()
    N = p.N
    n_tot, tot_len = 0, 0
    for j in range(q.M):
        x = query[j]
        # for each reference, mismatch positions give maximal match intervals
        best_end = np.zeros(N + 1, dtype=np.int64)
        best_seq = np.zeros(N + 1, dtype=np.int64)
        best_end[N] = N + 1
        for i in range(p.M):
            neq = np.flatnonzero(x != reference[i])
            k_last = N
            # process mismatches from the right
            for kk in range(len(neq) - 1, -1, -1):
                k = int(neq[kk])
                if k_last > best_end[k + 1]:
                    m = k + 1
                    while best_end[m] <= k_last:
                        best_end[m] = k_last
                        best_seq[m] = i
                        m += 1
                k_last = k
            if k_last > best_end[0]:
                m = 0
                while best_end[m] <= k_last:
                    best_end[m] = k_last
                    best_seq[m] = i
                    m += 1
        i_best = p.M
        for k in range(N):
            if best_seq[k] != i_best:
                i_best = int(best_seq[k])
                report(j, i_best, k, int(best_end[k]))
                n_tot += 1
                tot_len += int(best_end[k]) - k
    log(f"Average number of best matches {n_tot / q.M:.1f}, "
        f"Average length {tot_len / n_tot:.1f}")


def match_sequences_indexed(p: PBWT, q: PBWT, report=report_match_stdout,
                            device=None) -> None:
    """Algorithm 5 with materialised a/d/u indexes (matchSequencesIndexed,
    pbwtMatch.c:255-340).  O(N(M+Q)) time, ~13NM bytes memory.

    On the device route the state evolution runs on the DeviceMatcher;
    reports are re-sorted into this function's (query, end site) order, so
    output is identical."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    if _use_device(p):
        rows = _matcher(p, device).match(q.haplotypes())
        rows = rows[np.lexsort((np.arange(len(rows)), rows[:, 3],
                                rows[:, 0]))]
        events = np.unique(rows[:, [0, 2, 3]], axis=0)
        _report_rows(rows, report)
        n_tot = max(len(events), 1)
        tot_len = int((events[:, 2].astype(np.int64) - events[:, 1]).sum())
        log(f"Average number of best matches {n_tot / q.M:.1f}, "
            f"Average length {tot_len / n_tot:.1f}")
        return
    query = q.haplotypes()
    reference = p.haplotypes()
    N, M = p.N, p.M
    Y = p.decoded(True)
    # build indexes
    A = np.empty((N + 1, M), dtype=np.int32)
    D = np.empty((N + 1, M + 1), dtype=np.int32)
    U = np.empty((N, M + 1), dtype=np.int32)
    CC = np.empty(N, dtype=np.int32)
    a = p.aFstart.copy()
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = 1
    d[M] = 1
    for k in range(N):
        A[k] = a
        D[k] = d
        u, c = engine.calculate_u(Y[k])
        U[k] = u
        CC[k] = c
        a, d = engine.forwards_ad(a, d, Y[k], k)
    A[N] = a
    D[N] = d

    n_tot, tot_len = 0, 0
    for j in range(q.M):
        x = query[j]
        e, f, g = 0, 0, M
        for k in range(N):
            if x[k]:
                f1 = CC[k] + (f - U[k][f])
                g1 = CC[k] + (g - U[k][g])
            else:
                f1 = int(U[k][f])
                g1 = int(U[k][g])
            if g1 > f1:
                f, g = f1, g1
                continue
            # reached a maximum - report and reset e, f, g
            for i in range(f, g):
                report(j, int(A[k][i]), e, k)
            n_tot += 1
            tot_len += k - e
            e1 = int(D[k + 1][f1]) - 1
            # NB when f1 is 0 or M, e1 may be k+1 (sentinel d) and x[e1] can
            # be out of range, but the branch taken doesn't depend on it:
            # f1==M forces the first branch and f1==0 the second
            if f1 == M or (f1 > 0 and x[e1] == 0):
                f1 = g1 - 1
                y = reference[A[k + 1][f1]]
                while e1 > 0 and x[e1 - 1] == y[e1 - 1]:
                    e1 -= 1
                while D[k + 1][f1] <= e1:
                    f1 -= 1
            elif f1 < M:
                g1 = f1 + 1
                y = reference[A[k + 1][f1]]
                while e1 > 0 and x[e1 - 1] == y[e1 - 1]:
                    e1 -= 1
                while g1 < M and D[k + 1][g1] <= e1:
                    g1 += 1
            e, f, g = e1, f1, g1
        for i in range(f, g):
            report(j, int(A[N][i]), e, N)
        n_tot += 1
        tot_len += N - e
    log(f"Average number of best matches {n_tot / q.M:.1f}, "
        f"Average length {tot_len / n_tot:.1f}")


def match_sequences_sweep_rows(p: PBWT, q: PBWT):
    """The C sweep's match set as an (n, 4) int64 ndarray
    [iq, j_panel, start, end] in report order.

    Logs the same summary line as match_sequences_sweep
    (pbwtMatch.c:443-445) so pipeline stderr is unchanged."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    M, N, QM = p.M, p.N, q.M
    ap0 = p.aFstart if p.aFstart is not None else np.arange(M, dtype=np.int32)
    aq0 = q.aFstart if q.aFstart is not None else np.arange(QM, dtype=np.int32)
    if p.yz and q.yz:
        rows = native.sweep_match_packed(p.yz, M, q.yz, QM, N, ap0, aq0)
    else:
        rows = native.sweep_match(p.decoded(True), ap0, q.decoded(True), aq0)
    log_best_matches(rows, QM, N)
    return rows


def log_best_matches(rows: np.ndarray, QM: int, N: int) -> None:
    """The sweep's summary line of its (n, 4) rows (pbwtMatch.c:443-445)."""
    nz = rows[rows[:, 2] != rows[:, 3]]
    tot_len = int((nz[:, 3].astype(np.int64) - nz[:, 2]).sum())
    log(f"Average number of best matches including alternates "
        f"{len(rows) / QM:.1f}, Average length "
        f"{tot_len / max(len(nz), 1):.1f}, Av number per position "
        f"{tot_len / (QM * N):.1f}")


def match_sequences_sweep(p: PBWT, q: PBWT, report, device=None) -> None:
    """The production dynamic matcher (matchSequencesSweep,
    pbwtMatch.c:363-443): joint sweep of panel and query cursors keeping per
    query the best-match pointer f and its start d.

    On the device route the match set is computed by the DeviceMatcher and
    re-ordered into the sweep's exact report sequence (per end site, queries
    in query-PBWT sort order, pbwtMatch.c:376), so stdout is byte-identical
    to the host sweep."""
    if q.N != p.N:
        raise ValueError(f"query length {q.N} != PBWT length {p.N}")
    M, N, QM = p.M, p.N, q.M

    if _use_device(p):
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
        log(f"Average number of best matches including alternates "
            f"{n_tot / QM:.1f}, Average length "
            f"{tot_len / max(n_tot, 1):.1f}, Av number per position "
            f"{tot_len / (QM * N):.1f}")
        return

    ap0 = p.aFstart if p.aFstart is not None else np.arange(M, dtype=np.int32)
    aq0 = q.aFstart if q.aFstart is not None else np.arange(QM, dtype=np.int32)
    if p.yz and q.yz and report is report_match_stdout:
        # stream MATCH lines straight from the C sweep to the stdout fd
        sys.stdout.flush()
        fd = native._stdout_fd(sys.stdout)
        if fd >= 0:
            n_rep, tot_len, nz = native.sweep_match_print(
                p.yz, M, q.yz, QM, N, ap0, aq0, fd)
            log(f"Average number of best matches including alternates "
                f"{n_rep / QM:.1f}, Average length "
                f"{tot_len / max(nz, 1):.1f}, Av number per position "
                f"{tot_len / (QM * N):.1f}")
            return
    if p.yz and q.yz:
        rows = native.sweep_match_packed(p.yz, M, q.yz, QM, N, ap0, aq0)
    else:
        rows = native.sweep_match(p.decoded(True), ap0, q.decoded(True), aq0)
    _report_rows(rows, report)
    log_best_matches(rows, QM, N)


def match_sequences_dynamic(p: PBWT, fp, device=None) -> None:
    q = pbwtfile.read_pbwt(fp)
    match_sequences_sweep(p, q, report_match_stdout, device=device)
