"""Block import of a panel (``-readVcfGT``'s device route after parsing).

Set-up draws the configuration's panel on the device and cuts it, in natural
order, into blocks of whole 32-site groups of ``block_bytes`` (the rule of
``io/vcf.py``'s reader: block_bytes / M sites, rounded down to groups), each
an (n, M) uint8 array of site columns on the host; one block goes through a
``BlockBuild`` that is thrown away. The window streams the blocks in order
into a ``BlockBuild``, one ``add`` a request; the request that adds the
panel's last block also calls ``finish()`` and starts a new ``BlockBuild``.

The check: the plain construction and pack3 encoder (``reference/
construction.py``) run over the panel drawn again; every finished panel's yz
bytes and aFend, and those of the panel left open when the window closed
(finished after it), must be the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.generators.mosaic import Founders
from benchmark.harness import Check, free_device
from benchmark.reference import construction

GROUP = 32
ROW_MULTIPLE = 256      # BlockBuild pads rows to this multiple (ops/build.py)


class Driver:
    def __init__(self, run):
        self.run = run
        self.M, self.N = int(run.config["haplotypes"]), int(run.config["sites"])
        size = max(GROUP, int(run.traffic["block_bytes"]) // self.M // GROUP * GROUP)
        self.starts = list(range(0, self.N, size))
        self.panels: list = []          # (blocks added, yz, aFend)
        run.shapes.update(M=self.M, Mp=-(-self.M // ROW_MULTIPLE) * ROW_MULTIPLE)

    def setup(self) -> None:
        from pbwt_tpu_torch.core import native
        from pbwt_tpu_torch.ops.build import BlockBuild
        if native.get_lib() is None:
            raise RuntimeError("the port's host C runtime did not build")
        self.BlockBuild = BlockBuild
        dev = self.run.device
        X = Founders(self.run.config, self.run.seed, dev).panel(self.M)
        ends = self.starts[1:] + [self.N]
        self.blocks = [X[:, s:e].t().contiguous().cpu().numpy()
                       for s, e in zip(self.starts, ends)]
        del X
        free_device(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        warm = BlockBuild(self.M, device=dev)
        warm.add(self.blocks[0])
        warm.finish()
        self.build, self.added = BlockBuild(self.M, device=dev), 0

    def hooks(self, spans) -> None:
        from pbwt_tpu_torch.ops import build
        spans.wrap(build, "pack_column_words", "ops.pack_column_words")
        spans.wrap(build, "encode_columns", "host.encode_columns")

    def _add(self):
        blk = self.blocks[self.added]
        self.build.add(blk)
        self.added += 1
        if self.added < len(self.blocks):
            return None
        yz, a = self.build.finish()
        self.build, self.added = self.BlockBuild(self.M, device=self.run.device), 0
        return len(self.blocks), yz, a

    def serve(self, client) -> None:
        while True:
            n = len(self.blocks[self.added])
            client.request(self._add,
                           lambda out: out is None or self.panels.append(out),
                           hap_sites=n * self.M, sites=n)

    def after_window(self) -> None:
        if self.added:
            self.panels.append((self.added, *self.build.finish()))
        del self.build, self.blocks

    def references(self, one_tier: bool = False):
        cols = Founders(self.run.config, self.run.seed, self.run.device) \
            .panel(self.M).t().contiguous()
        return construction.build(cols, self.starts + [self.N], one_tier)

    def _site(self, blocks: int) -> int:
        return self.starts[blocks] if blocks < len(self.starts) else self.N

    def _compare(self, panels, yz, marks) -> list:
        """(blocks, yz, aFend) panels against the reference's at their
        block."""
        nb = na = 0
        for blocks, got_yz, got_a in panels:
            size, want_a = marks[self._site(blocks)]
            want = np.frombuffer(yz, np.uint8)[:size]
            got = np.frombuffer(got_yz, np.uint8)
            n = min(len(got), len(want))
            nb += int((got[:n] != want[:n]).sum()) + abs(len(got) - len(want))
            na += int((np.asarray(got_a, np.int64) != want_a).sum()) \
                if len(got_a) == len(want_a) else len(want_a)
        limits = self.run.traffic["limits"]
        return [Check("yz_bytes_differing", nb, limits["yz_bytes_differing"]),
                Check("afend_differing", na, limits["afend_differing"]),
                Check("nothing_compared", int(not panels), 0)]

    def check(self) -> list:
        yz, _, marks = self.references()
        return self._compare(self.panels, yz, marks)

    def control(self) -> list:
        """The reference with a one-tier run-length code (bytes of at most
        63 a run, which decode alike) in the program's place."""
        yz, _, marks = self.references()
        c_yz, _, c_marks = self.references(one_tier=True)
        panels = [(b, c_yz[:c_marks[self._site(b)][0]], c_marks[self._site(b)][1])
                  for b, _, _ in self.panels]
        return self._compare(panels, yz, marks)
