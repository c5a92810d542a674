"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
configurations and traffic are cut to a size the CPU's plain twins run in
seconds, made of data files alone."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_CONFIGS = {"hrc": {"haplotypes": 300, "sites": 256},
                "kgp3": {"haplotypes": 120, "sites": 320}}
TINY_TRAFFIC = {"match_q1024": {"batch": 16, "pool_batches": 3},
                "match_q256": {"batch": 8, "pool_batches": 4},
                "copy_model_fit": {"region_sites": 40},
                "import_blocks": {"block_bytes": 300 * 64}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def copy_benchmark(dest: str) -> dict:
    """The benchmark (BENCHMARK.json and benchmark/) copied to dest;
    returns the copy's BENCHMARK.json as a dict."""
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    write_json(os.path.join(dest, "BENCHMARK.json"), spec)
    return spec


def write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def update_json(path: str, **kv) -> None:
    with open(path) as f:
        obj = json.load(f)
    obj.update(kv)
    write_json(path, obj)


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A copy of the benchmark at toy sizes on the CPU (the port's device
    routes on CPU tensors); yields its root."""
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    spec = copy_benchmark(str(tmp_path))
    for c in spec["configs"]:
        update_json(os.path.join(tmp_path, c["file"]), **TINY_CONFIGS[c["name"]])
    for t, kv in TINY_TRAFFIC.items():
        update_json(os.path.join(tmp_path, "benchmark", "traffic", f"{t}.json"), **kv)
    return str(tmp_path)
