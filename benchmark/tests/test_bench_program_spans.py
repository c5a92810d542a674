"""The per-layer metrics read from the program's own spans
(``metrics/_program_spans.py``): each reads a number in a traced toy-size run
of its cells and nothing untraced; every per-layer metric that reads on the
CPU still reads; and where the program has no spans the readers return None
and raise nothing."""

import json
import os
import sys

import pytest
import torch

from benchmark import harness
from conftest import ROOT

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NEW = {m["name"]: m["workloads"] for m in SPEC["per_layer"]
       if m["name"] in ("ops.match_download_ms", "ops.match_scan_ms",
                        "ops.build_pack_ms", "ops.setup_s")}
# per-layer metrics whose reading needs the card's kernels in the trace
CARD_ONLY = {"k3_match_scan.roofline_pct", "k1_group_partition.roofline_pct",
             "k4_ls_eval.roofline_pct", "device_idle_pct.match",
             "device_idle_pct.import", "device_idle_pct.copy_model",
             "algos.host_ms_per_eval"}
CELLS = [w["name"] for w in SPEC["workloads"]]


def run(base, cell, traced, monkeypatch):
    """run_cell at toy size on the CPU; returns (result, the readers'
    Context)."""
    seen = []
    real = harness.Context
    monkeypatch.setattr(harness, "Context",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    res = harness.run_cell(harness.load_cell(cell, base), 2**31 + 71, 0.3,
                           traced, torch.device("cpu"), 0.0,
                           log=lambda *a, **k: None)
    return res, seen[0]


def test_four_new_metrics_declared():
    assert set(NEW) == {"ops.match_download_ms", "ops.match_scan_ms",
                        "ops.build_pack_ms", "ops.setup_s"}
    assert set(NEW["ops.setup_s"]) == set(CELLS)
    for m in SPEC["per_layer"]:
        if m["name"] in NEW:
            assert m["source"] == "program_span" and m["layer"] == "ops"


@pytest.mark.parametrize("cell", CELLS)
def test_new_readers_read_traced_and_not_untraced(tiny, monkeypatch, cell):
    res, _ = run(tiny, cell, True, monkeypatch)
    assert res["correct"], res["checks"]
    for name, cells in NEW.items():
        if cell in cells:
            assert res["metrics"][name]["value"] > 0, name
    cell_metrics = {m["name"] for m in harness.load_cell(cell, tiny).per_layer}
    assert set(res["metrics"]) == cell_metrics - CARD_ONLY
    res, ctx = run(tiny, cell, False, monkeypatch)
    assert res["correct"]
    for name in (n for n, cells in NEW.items() if cell in cells):
        value = harness.metric_reader(ctx.run.cell, name).read(ctx)
        assert value is None or name == "ops.setup_s", (name, value)


def test_setup_reads_the_programs_share(tiny, monkeypatch):
    """ops.setup_s: the outermost spans closed before the window, set-up
    spans and warm-up calls, and none of the window's."""
    from pbwt_tpu_torch import tracing
    tracing.reset()
    res, ctx = run(tiny, "hrc.match_q1024", True, monkeypatch)
    tot = tracing.totals()
    window = tracing.records("ops.match", ctx.client.start)
    assert len(window) == res["attempted"]
    warm = tot["ops.match"].root_s - sum(r.seconds for r in window)
    want = tot["setup.matcher"].root_s + warm
    assert warm > 0
    assert res["metrics"]["ops.setup_s"]["value"] == pytest.approx(want)


def test_readers_without_the_programs_spans(tiny, monkeypatch):
    """A checkout of the program without ``pbwt_tpu_torch.tracing``: the
    readers return None."""
    res, ctx = run(tiny, "hrc.match_q1024", True, monkeypatch)
    import pbwt_tpu_torch
    monkeypatch.delattr(pbwt_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "pbwt_tpu_torch.tracing", None)
    for name in NEW:
        assert harness.metric_reader(ctx.run.cell, name).read(ctx) is None
