"""The port's bench hooks on the CPU against the JAX package's: the data
recipes of pbwt_tpu_torch.bench against the root bench.py's, the cold-panel
matcher ops/match.match_queries_device against match_jax's (the shapes of
tests/test_match_device.py), entry() against __graft_entry__.entry(), and
both bench modules refusing to run without a CUDA card."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jbench
import __graft_entry__ as graft
from pbwt_tpu.ops import build as jbuild
from pbwt_tpu.ops import match_jax
from pbwt_tpu_torch import bench
from pbwt_tpu_torch.ops import build, match

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mosaic(seed, M, N, founders=5, switch=0.04):
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((founders, N)) < 0.4).astype(np.uint8)
    X = np.empty((M, N), np.uint8)
    for i in range(M):
        f = rng.randint(founders)
        for k in range(N):
            if rng.random_sample() < switch:
                f = rng.randint(founders)
            X[i, k] = F[f, k]
    return X


# M above the 16,384-haplotype tile; N = 100 not a multiple of 32, and 1,100
# more than one block of sites of the port's draw
@pytest.mark.parametrize("N", [100, 1_100])
def test_build_words_match_root_bench(N):
    M = 20_000
    Mp = build.pad_to(M, 256)
    got = bench.build_words(M, N, Mp)
    want = jbench.build_words(M, N, Mp)
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


def test_bench_match_data_matches_root_bench():
    for got, want in zip(bench.bench_match_data(3_000, 300, 64),
                         jbench.bench_match_data(3_000, 300, 64)):
        assert got.dtype == want.dtype
        assert np.array_equal(got, want)


def duplicated_row_case():
    """tests/test_match_device.py's segment test: a duplicated panel row."""
    rng = np.random.RandomState(42)
    M, N, Q = 300, 96, 20
    Xp = mosaic(3, M, N)
    Xp[37] = Xp[5]
    Xq = np.empty((Q, N), np.uint8)
    for q in range(Q):
        pos = 0
        while pos < N:
            seg = rng.randint(10, 40)
            src = rng.randint(0, M)
            Xq[q, pos:pos + seg] = Xp[src, pos:pos + seg]
            pos += seg
    return Xp, Xq


@pytest.mark.parametrize("case", ["dup300", "m24", "m30"])
def test_match_queries_device_matches_jax(case):
    if case == "dup300":
        Xp, Xq = duplicated_row_case()
    else:                               # M = 30: not a multiple of 8
        seed, M = {"m24": (0, 24), "m30": (1, 30)}[case]
        Xp, Xq = mosaic(seed, M, 64), mosaic(seed + 10, 5, 64)
    got = match.match_queries_device(Xp, Xq, device="cpu")
    want = np.asarray(match_jax.match_queries_device(Xp, Xq))
    assert len(got) > len(Xq)
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


def test_entry_matches_graft_entry():
    fn, args = bench.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    ycols, counts, a_end, d_end = fn(*args)
    jfn, jargs = graft.entry()
    ybits, jcounts, ja_end, jd_end = (np.asarray(x) for x in jfn(*jargs))
    M = 1024
    assert np.array_equal(build.unpack_columns(ycols.numpy(), M),
                          jbuild.unpack_bits_host(ybits, M))
    assert np.array_equal(counts.numpy(), jcounts)
    assert np.array_equal(a_end.numpy(), ja_end)
    assert np.array_equal(d_end.numpy(), jd_end)


def test_figures_are_median_min_max():
    secs = [0.5, 0.1, 0.4, 0.2, 0.3]
    assert bench.rate("r", 6.0, secs) == pytest.approx(
        {"r": 20.0, "r_min": 12.0, "r_max": 60.0})
    assert bench.seconds("s", secs) == {"s": 0.3, "s_min": 0.1, "s_max": 0.5}


@pytest.mark.parametrize("setting", [None, "cpu"])
@pytest.mark.parametrize("module,args", [
    ("pbwt_tpu_torch.bench", ["256", "64", "300", "8"]),
    ("pbwt_tpu_torch.bench_match", ["300", "64", "8"])])
def test_bench_refuses_without_a_card(module, args, setting):
    """No card: a message on stderr, no metric line, a non-zero exit, also
    where PBWT_TORCH_DEVICE names the CPU (the twins are never timed)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=ROOT)
    env.pop("PBWT_TORCH_DEVICE", None)
    if setting is not None:
        env["PBWT_TORCH_DEVICE"] = setting
    res = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=120)
    assert res.returncode != 0
    assert "no CUDA card" in res.stderr
    for out_line in res.stdout.splitlines():
        try:
            obj = json.loads(out_line)
        except ValueError:
            continue
        assert "metric" not in obj, out_line
