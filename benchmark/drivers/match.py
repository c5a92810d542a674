"""Standing-panel matching (``-matchDynamic``'s device route).

Set-up draws the configuration's panel and a pool of query batches on the
device, hands the panel to ``DeviceMatcher`` (which builds its standing
tables on the card) and matches every pooled batch once, so that the record
cap the matcher learns for the batch size is learned before the window.
The window sends the pooled batches in turn, one ``match`` call a request,
each returning its rows on the host.

The check: a sample of the queries of each pooled batch, drawn from the
seed, is matched again by the plain reference (``reference/match.py``) on
the panel drawn again; the rows that the program returned for them in a
few requests of the window (a reservoir drawn from the seed) must be the
reference's, row for row.
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from benchmark.generators.mosaic import Founders, stream_seed
from benchmark.harness import Check, free_device
from benchmark.reference.match import set_maximal_rows


def _count_records(counters: dict, out) -> None:
    counters.setdefault("k3.records", []).append(out[4])   # a device tensor


class Driver:
    def __init__(self, run):
        self.run = run
        cfg, t = run.config, run.traffic
        self.M, self.N = int(cfg["haplotypes"]), int(cfg["sites"])
        self.Q, self.P = int(t["batch"]), int(t["pool_batches"])
        self.kept: list = []
        self.rng = random.Random(stream_seed(run.seed, "kept"))
        run.shapes.update(M=self.M, N=self.N, Q=self.Q)

    def setup(self) -> None:
        from pbwt_tpu_torch.ops.match import DeviceMatcher
        dev = self.run.device
        f = Founders(self.run.config, self.run.seed, dev)
        Xp = f.panel(self.M).cpu().numpy()
        self.pool = [f.queries(self.Q, b).cpu().numpy() for b in range(self.P)]
        del f
        free_device(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.matcher = DeviceMatcher(Xp, device=dev)
        del Xp
        rows = [len(self.matcher.match(self.pool[b])) for b in range(self.P)]
        # the rows a query set every batch's download and expansion; the
        # mosaic recipe decides them, and no public panel's figure is known
        print(f"pool: rows a query {sum(rows) / (self.Q * self.P):.1f}, "
              f"rows a batch {min(rows)} to {max(rows)}", file=sys.stderr)

    def hooks(self, spans) -> None:
        from pbwt_tpu_torch.ops import match
        spans.wrap(match, "pack_row_words", "ops.pack_row_words")
        spans.wrap(match, "match_scan_indexed", "ops.match_scan_indexed",
                   count=_count_records)

    def _keep(self, i: int, b: int, rows: np.ndarray) -> None:
        """Reservoir of the results of kept_results requests."""
        k = int(self.run.traffic["kept_results"])
        if len(self.kept) < k:
            self.kept.append((i, b, rows))
        else:
            j = self.rng.randrange(i + 1)
            if j < k:
                self.kept[j] = (i, b, rows)

    def serve(self, client) -> None:
        i = 0
        while True:
            b = i % self.P
            client.request(lambda: self.matcher.match(self.pool[b]),
                           lambda rows: self._keep(i, b, rows),
                           queries=self.Q)
            i += 1

    def after_window(self) -> None:
        del self.matcher, self.pool

    def sample(self) -> dict:
        """Batch -> the sorted indices of its sampled queries."""
        rng = random.Random(stream_seed(self.run.seed, "sample"))
        s = int(self.run.traffic["sampled_queries"])
        return {b: sorted(rng.sample(range(self.Q), min(s, self.Q)))
                for b in range(self.P)}

    def reference_rows(self, f: Founders, batches, sample, **kw) -> dict:
        """Batch -> the reference's rows (q in the batch, hap, start, end)
        of its sampled queries, all batches in one walk over the panel."""
        cols = f.panel(self.M).t().contiguous()
        Z = torch.cat([f.queries(self.Q, b)[sample[b]] for b in batches])
        rows = set_maximal_rows(cols, Z, **kw)
        del cols
        qmap = np.concatenate([sample[b] for b in batches])
        owner = np.repeat(np.arange(len(batches)), [len(sample[b]) for b in batches])
        out = {}
        for n, b in enumerate(batches):
            r = rows[owner[rows[:, 0]] == n]
            r[:, 0] = qmap[r[:, 0]]
            out[b] = r
        return out

    def _compare(self, one_per_match: bool = False) -> list:
        """The rows of the kept requests' sampled queries against the
        reference's; one_per_match puts the control (the reference that
        keeps one haplotype a match) in the program's place."""
        sample = self.sample()
        batches = sorted({b for _, b, _ in self.kept})
        f = Founders(self.run.config, self.run.seed, self.run.device)
        ref = self.reference_rows(f, batches, sample)
        ctrl = self.reference_rows(f, batches, sample, one_per_match=True) \
            if one_per_match else None
        differ = compared = 0
        for _, b, rows in self.kept:
            got = ctrl[b] if ctrl else \
                rows[np.isin(rows[:, 0], sample[b])].astype(np.int64)
            differ += rows_differing(got, ref[b])
            compared += len(ref[b])
        return [Check("rows_differing", differ,
                      self.run.traffic["limits"]["rows_differing"]),
                Check("nothing_compared", int(compared == 0), 0)]

    def check(self) -> list:
        return self._compare()

    def control(self) -> list:
        return self._compare(one_per_match=True)


def rows_differing(got: np.ndarray, want: np.ndarray) -> int:
    """Rows in one of the two (n, 4) arrays and not the other, counted with
    their multiplicity."""
    if got.shape == want.shape:
        g = got[np.lexsort((got[:, 1], got[:, 3], got[:, 0]))]
        if np.array_equal(g, want):
            return 0
    a = {}
    for r in map(tuple, got.tolist()):
        a[r] = a.get(r, 0) + 1
    for r in map(tuple, want.tolist()):
        a[r] = a.get(r, 0) - 1
    return sum(abs(v) for v in a.values())
