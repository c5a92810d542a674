#!/usr/bin/env python3
"""Where a benchmark cell's requests spend their time, from the port's own
spans (pbwt_tpu_torch.tracing).

Run from the repository root on a machine with one CUDA card:

    python3 tools/span_probe.py --workload <cell> --seed <n> --seconds <s> \
        [--trace 0|1]

A run of the cell as ``benchmark/run.py`` makes it (the same
``harness.run_cell``; its result line printed first, as run.py prints it),
then one JSON line ``spans``:

- ``disabled_span_us``: what one span costs with no profiler running, the
  least of 15 timings of 100,000 empty spans on this host;
- ``end_to_end``: the cell's end-to-end metrics read over this run's window
  (traced or not, so that a traced run and an untraced one give the cost of
  tracing when on);
- traced: ``coverage``, the share of the requests' summed time that the
  outermost spans cover; ``per_request``: per span name, its calls,
  milliseconds and self milliseconds a request over the window's records;
  ``counters``: each counter's sum over the process, a request in the
  window where the window is the only user.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import timeit  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.process import prepare  # noqa: E402


def span_cost_us(tracing) -> float:
    ts = timeit.repeat("with span('x'): pass", globals={"span": tracing.span},
                       number=100_000, repeat=15)
    return min(ts) * 10.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    prepare()
    import torch
    from benchmark import harness
    from pbwt_tpu_torch import tracing
    if not torch.cuda.is_available():
        print("span_probe.py: no CUDA card", file=sys.stderr)
        return 2
    seen = []
    real = harness.Context
    harness.Context = lambda *a: seen.append(real(*a)) or seen[-1]
    cell = harness.load_cell(args.workload)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    print(json.dumps(result), flush=True)
    ctx = seen[0]
    reqs = ctx.client.requests
    req_s = sum(r.end - r.start for r in reqs)
    recs = tracing.records(t0=ctx.client.start, t1=reqs[-1].end)
    per = {}
    for r in recs:
        p = per.setdefault(r.name, [0, 0.0, 0.0])
        p[0] += 1
        p[1] += r.seconds
        p[2] += r.self_s
    n = len(reqs)
    e2e = {m["name"]: harness.metric_reader(cell, m["name"]).read(ctx)
           for m in cell.end_to_end}
    out = {
        "workload": args.workload, "seed": args.seed,
        "traced": bool(args.trace), "requests": n,
        "window_s": ctx.client.window_s, "request_s": req_s,
        "end_to_end": e2e,
        "disabled_span_us": span_cost_us(tracing),
        "coverage": (sum(r.seconds for r in recs if r.parent is None) / req_s
                     if recs else None),
        "per_request": {k: [v[0] / n, 1e3 * v[1] / n, 1e3 * v[2] / n]
                        for k, v in sorted(per.items(),
                                           key=lambda kv: -kv[1][1])},
        "counters": tracing.counters(),
        "totals": {k: list(v) for k, v in tracing.totals().items()},
    }
    print(json.dumps({"spans": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
