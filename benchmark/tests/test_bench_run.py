"""run.py refuses to run where it cannot measure: without a card, and in a
folder that holds the benchmark but not the port."""

import os
import subprocess
import sys

import pytest

from conftest import ROOT, copy_benchmark

ARGS = ["--workload", "kgp3.copy_model_fit", "--seed", str(2**31 + 3),
        "--seconds", "1", "--trace", "0"]


def run(root, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for env in ({}, {"PBWT_TORCH_DEVICE": "cpu"}):
        res = run(ROOT, env)
        assert res.returncode != 0 and res.stdout.strip() == ""


def test_without_the_port_no_result(tmp_path):
    copy_benchmark(str(tmp_path))
    res = run(str(tmp_path))
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
def test_a_cell_on_the_card(card):
    import json
    res = run(ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
