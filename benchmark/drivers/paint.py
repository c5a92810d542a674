"""Painting a panel by itself (``-paint OUT chunks ploidy``'s device route).

Set-up draws ``pool_regions`` regions of the configuration's population on
the device, each of ``region_sites`` sites (or the configuration's sites,
if fewer) and the configuration's haplotypes, drawn alone from a stream of
the seed of its own, and builds each one's PBWT through the port's block
construction (``BlockBuild`` in blocks of ``io/vcf.BLOCK_BYTES``, as
``-readVcfGT`` does on a card). The first region is painted once before the
others are drawn: that warms every stage, and a program whose
``paint_ancestry_matrix`` returns no tables fails there, at once. The
window paints the regions in turn, one whole-panel
``paint_ancestry_matrix(p, root, chunks_per_region, ploidy)`` a request:
the host's collection of within-panel matches, K6 on the card, the four
tables downloaded, normalised and written under one file root in a fresh
directory of ``/dev/shm`` (a tmpfs, so no write reaches a disk), or of the
system's temporary directory where the machine has no writable ``/dev/shm``
(each request overwrites the same four files; stderr names the directory),
the tables returned on the host.

The check: ``sampled_individuals`` recipient individuals of each region are
drawn from the seed, and a reservoir of ``kept_results`` requests of the
window, drawn from the seed, keeps their rows of the returned tables. The
plain reference (``reference/paint.py``) paints those rows again on the
region drawn again: ``table_rel_gap`` is the largest difference over the
four tables' sampled rows, each over its table's largest absolute entry
there (the reference sums in f64 in another order), and the rows' nregions
must be the reference's. The last request's four files, read after the
window, must hold its returned tables' sampled rows as pbwtPaint.c prints
them (``IND%d``, `` %.4f``, ``%.2f`` for nregions), rendered here in
Python. The control puts the reference computed in float32 in the
program's place.
"""

from __future__ import annotations

import atexit
import os
import random
import shutil
import sys
import tempfile

import numpy as np
import torch

from benchmark.generators.mosaic import Founders, stream_seed
from benchmark.harness import Check, Spans, free_device
from benchmark.reference import paint as reference
from benchmark.rooflines.k6_paint_accumulate import covering_pairs

# the four files, in the order of the tables paint_ancestry_matrix returns
TAGS = ("chunkcounts", "chunklengths", "regionsquaredchunkcounts",
        "regionchunkcounts")


def rendered(tag: str, i: int, row: np.ndarray, nregions: float) -> str:
    """Row i of the file ``tag`` as pbwtPaint.c:176-204 prints it."""
    head = f"IND{i + 1}"
    if tag.startswith("region"):
        head += f" {nregions:.2f}"
    return head + "".join(f" {v:.4f}" for v in row)


class Driver:
    def __init__(self, run):
        self.run = run
        cfg, t = run.config, run.traffic
        self.M = int(cfg["haplotypes"])
        self.N = min(int(t["region_sites"]), int(cfg["sites"]))
        self.P = int(t["pool_regions"])
        self.cpr, self.ploidy = int(t["chunks_per_region"]), int(t["ploidy"])
        self.n_inds = self.M // self.ploidy
        rng = random.Random(stream_seed(run.seed, "sample"))
        s = min(int(t["sampled_individuals"]), self.n_inds)
        self.sampled = [sorted(rng.sample(range(self.n_inds), s))
                        for _ in range(self.P)]
        self.kept: list = []            # (request, region, sampled rows)
        self.last = None                # the last request's region and rows
        self.rng = random.Random(stream_seed(run.seed, "kept"))
        run.shapes.update(M=self.M, N=self.N, ploidy=self.ploidy)

    def region(self, r: int) -> torch.Tensor:
        """Region r's (M, N) uint8 panel on the device."""
        cfg = dict(self.run.config, sites=self.N)
        seed = stream_seed(self.run.seed, "region", str(r))
        return Founders(cfg, seed, self.run.device).panel(self.M)

    def _pbwt(self, r: int):
        from pbwt_tpu_torch.core.pbwt import PBWT
        from pbwt_tpu_torch.io.vcf import BLOCK_BYTES
        from pbwt_tpu_torch.ops.build import BlockBuild
        X = self.region(r)
        build = BlockBuild(self.M, device=self.run.device)
        size = max(32, BLOCK_BYTES // self.M // 32 * 32)
        for s0 in range(0, self.N, size):
            build.add(X[:, s0:s0 + size].t().contiguous().cpu().numpy())
        p = PBWT(self.M, self.N)
        p.yz, p.aFend = build.finish()
        return p

    def _paint(self, r: int):
        return self.paint(self.pool[r], self.root, self.cpr, self.ploidy)

    def setup(self) -> None:
        from pbwt_tpu_torch.algos.paint import paint_ancestry_matrix
        self.paint = paint_ancestry_matrix
        dev = self.run.device
        shm = "/dev/shm"
        self.dir = tempfile.mkdtemp(
            prefix="pbwt_paint_",
            dir=shm if os.path.isdir(shm) and os.access(shm, os.W_OK)
            else None)
        print(f"tables written under {self.dir}", file=sys.stderr)
        atexit.register(shutil.rmtree, self.dir, True)  # a failed run too
        self.root = os.path.join(self.dir, "paint")
        self.pool = [self._pbwt(0)]
        free_device(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        # one whole request warms every stage before the others are drawn;
        # its segments and weighed pairs are the mosaic recipe's, and no
        # public panel's figure is known
        warm = Spans()
        self.hooks(warm)
        try:
            tables = self._paint(0)
        finally:
            warm.unwrap()
        if tables is None:
            raise RuntimeError("paint_ancestry_matrix returned no tables: "
                               "this program cannot be checked")
        (pairs, _, nseg, _), = warm.counters["k6.pairs"]
        print(f"region 0: {nseg} segments, {int(pairs)} weighed pairs",
              file=sys.stderr)
        self.pool += [self._pbwt(r) for r in range(1, self.P)]
        free_device(dev)

    def hooks(self, spans) -> None:
        """K6's weighed pairs, counted from each accumulation's arguments."""
        from pbwt_tpu_torch.ops import paint
        real = paint.paint_accumulate
        pairs = spans.counters.setdefault("k6.pairs", [])

        def counted(seg_off, sj, ss, se, M, N, ploidy, cpr):
            pairs.append((covering_pairs(seg_off, sj, ss, se, N, ploidy),
                          M, sj.numel(), ploidy))            # on the card
            return real(seg_off, sj, ss, se, M, N, ploidy, cpr)
        paint.paint_accumulate = counted
        spans._undo.append((paint, "paint_accumulate", real))

    def _rows(self, r: int, tables) -> list:
        """The sampled individuals' rows of the returned tables."""
        at = self.sampled[r]
        return [np.array(t[at], np.float64) for t in tables]

    def _keep(self, i: int, r: int, tables) -> None:
        """The last request's rows, and a reservoir of kept_results
        requests' rows."""
        rows = self._rows(r, tables)
        self.last = (r, rows)
        k = int(self.run.traffic["kept_results"])
        if len(self.kept) < k:
            self.kept.append((i, r, rows))
        else:
            j = self.rng.randrange(i + 1)
            if j < k:
                self.kept[j] = (i, r, rows)

    def serve(self, client) -> None:
        i = 0
        while True:
            r = i % self.P
            client.request(lambda: self._paint(r),
                           lambda tables: self._keep(i, r, tables),
                           hap_sites=self.M * self.N)
            i += 1

    def after_window(self) -> None:
        """Reads the last request's sampled rows of the four files and
        removes them."""
        self.file_rows = {}
        if self.last is not None:
            at = {1 + i for i in self.sampled[self.last[0]]}
            for tag in TAGS:
                with open(f"{self.root}.{tag}.out") as f:
                    self.file_rows[tag] = [ln.rstrip("\n")
                                           for n, ln in enumerate(f) if n in at]
        shutil.rmtree(self.dir, ignore_errors=True)
        del self.pool

    def _reference(self, regions, dtype) -> dict:
        """Region -> the reference's sampled rows, in dtype, as f64 numpy."""
        out = {}
        for r in regions:
            cols = self.region(r).t().contiguous()
            haps = [h for i in self.sampled[r]
                    for h in range(i * self.ploidy, (i + 1) * self.ploidy)]
            segs = {h: reference.segments(cols, h) for h in haps}
            del cols
            got = reference.tables(segs, self.sampled[r], self.M, self.N,
                                   self.ploidy, self.cpr, dtype,
                                   self.run.device)
            out[r] = [t.double().cpu().numpy() for t in got]
        return out

    def _compare(self, dtype=None) -> list:
        """The kept rows against the reference's; with dtype (a precision
        below float64), the reference made so in the program's place. The
        last request's file rows against its returned rows."""
        regions = sorted({r for _, r, _ in self.kept})
        want = self._reference(regions, torch.float64)
        got = ({r: rows for _, r, rows in self.kept} if dtype is None
               else self._reference(regions, dtype))
        gap, nreg, compared = 0.0, 0, 0
        for _, r, rows in self.kept:
            have = rows if dtype is None else got[r]
            for g, w in zip(have[:4], want[r][:4]):
                diff = float(np.abs(g - w).max(initial=0.0))
                top = float(np.abs(w).max(initial=0.0))
                gap = max(gap, diff / top if top else
                          (0.0 if diff == 0 else float("inf")))
                compared += w.size
            nreg += int((have[4] != want[r][4]).sum())
        files = 0
        if self.last is not None:
            r, rows = self.last
            for n, tag in enumerate(TAGS):
                lines = self.file_rows.get(tag, [])
                need = [rendered(tag, i, rows[n][j], rows[4][j])
                        for j, i in enumerate(self.sampled[r])]
                files += sum(a != b for a, b in zip(lines, need)) + abs(
                    len(lines) - len(need))
                compared += len(need)
        limits = self.run.traffic["limits"]
        return [Check("table_rel_gap", gap, float(limits["table_rel_gap"])),
                Check("nregions_differing", nreg,
                      limits["nregions_differing"]),
                Check("file_rows_differing", files,
                      limits["file_rows_differing"]),
                Check("nothing_compared", int(compared == 0), 0)]

    def check(self) -> list:
        return self._compare()

    def control(self) -> list:
        """The reference in float32, the precision below the
        configuration's float64: its weights (k - s)(e - k) pass 2^24 and
        its sums round, so its tables leave the limit; its nregions, counts
        of advances, are float64's."""
        return self._compare(torch.float32)
