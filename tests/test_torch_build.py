"""The port's device construction on the CPU (plain twin of K1) against the
JAX package's build_pbwt_device and the host engine: the same pack3 bytes,
final prefix array and zero counts."""

import numpy as np
import pytest
import torch

from pbwt_tpu.core import engine
from pbwt_tpu.ops import build as jbuild
from pbwt_tpu_torch.ops import build

torch.set_num_threads(1)


def rand_haps(seed, M, N, maf=0.3):
    rng = np.random.RandomState(seed)
    return (rng.random_sample((M, N)) < maf).astype(np.uint8)


def _check_host(X, yz, a_end, counts):
    M, N = X.shape
    yz_h, a_h = engine.build_from_haplotypes(X)
    assert yz == yz_h
    assert np.array_equal(a_end, a_h)
    a = np.arange(M)
    for k in range(N):
        y = X[a, k]
        assert counts[k] == int((y == 0).sum()), k
        a = engine.forwards_a(a, y)


@pytest.mark.parametrize("seed,M,N", [(0, 24, 40), (6, 16, 70), (7, 32, 32),
                                      (1, 30, 40)])
def test_build_matches_jax_and_host(seed, M, N):
    X = rand_haps(seed, M, N)
    yz, a_end, counts = build.build_pbwt_device(X, device="cpu")
    yz_j, a_j, counts_j = jbuild.build_pbwt_device(X, multiple=8)
    assert yz == yz_j
    assert np.array_equal(a_end, a_j)
    assert np.array_equal(counts, np.asarray(counts_j)[:N])
    _check_host(X, yz, a_end, counts)


@pytest.mark.parametrize("M,N", [(24, 40), (30, 37), (256, 64), (255, 70)])
def test_group_words_match_jax(M, N):
    """Row-wise word packing == the JAX package's column-wise packing,
    all-ones pad rows and pad sites included."""
    X = rand_haps(M + N, M, N)
    cols, Mp = jbuild.prepare_columns(X)
    assert np.array_equal(build.pack_group_words(X, Mp),
                          jbuild.pack_group_words(cols))


@pytest.mark.parametrize("M", [255, 256, 4095, 4097])
def test_build_tile_edges_match_host(M):
    X = rand_haps(M, M, 37, maf=0.2)
    X[: M // 4] = X[0]                    # duplicate rows: long equal runs
    _check_host(X, *build.build_pbwt_device(X, device="cpu"))
