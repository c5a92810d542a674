"""Every cell of BENCHMARK.json resolves to its files by name, and a cell
made of data files alone runs without a change to any code."""

import json
import os

import torch

from benchmark import harness
from conftest import ROOT, copy_benchmark, write_json

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_every_cell_resolves_by_name():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.driver, "Driver")
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        for m in names:
            assert hasattr(harness.metric_reader(cell, m), "read")


def test_every_metric_and_config_is_used():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}


def test_a_cell_of_data_files_runs(tmp_path, monkeypatch):
    """A new configuration and traffic mix, as JSON files and entries of
    BENCHMARK.json, on the drivers and readers that are there."""
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    spec = copy_benchmark(str(tmp_path))
    conf = json.load(open(os.path.join(ROOT, "benchmark", "configs", "kgp3.json")))
    conf.update(name="fixture", haplotypes=90, sites=200)
    write_json(tmp_path / "benchmark" / "configs" / "fixture.json", conf)
    write_json(tmp_path / "benchmark" / "traffic" / "match_q5.json",
               {"driver": "match", "batch": 5, "pool_batches": 2,
                "sampled_queries": 3, "kept_results": 2,
                "limits": {"rows_differing": 0}})
    spec["configs"].append({"name": "fixture", "source": "https://example.org",
                            "file": "benchmark/configs/fixture.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "fixture.match_q5", "config": "fixture",
                              "traffic": "match_q5", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "hrc.match_q1024" in m.get("workloads", []):
            m["workloads"].append("fixture.match_q5")
    write_json(tmp_path / "BENCHMARK.json", spec)
    cell = harness.load_cell("fixture.match_q5", str(tmp_path))
    res = harness.run_cell(cell, 12345, 0.5, False, torch.device("cpu"), 0.0,
                           log=lambda *a, **k: None)
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"queries_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


def test_every_cell_runs_at_toy_size(tiny):
    spec = json.load(open(os.path.join(tiny, "BENCHMARK.json")))
    for w in spec["workloads"]:
        for traced in (False, True):
            cell = harness.load_cell(w["name"], tiny)
            res = harness.run_cell(cell, 2**31 + 11, 0.3, traced,
                                   torch.device("cpu"), 0.0,
                                   log=lambda *a, **k: None)
            assert res["correct"], (w["name"], res["checks"])
            assert res["attempted"] >= 1 and res["failed"] == 0
            if not traced:
                assert {m["name"] for m in cell.end_to_end} == set(res["metrics"])
            else:
                assert "breakdown" in res and "busy_s" in res["device"]
