"""The generator draws the same bits from the same seed and others from
another."""

import numpy as np
import pytest
import torch

from benchmark.generators.mosaic import Founders, beta_02_08, generator

CFG = {"sites": 300, "assumed": {"founders": 20, "switch_rate": 0.01,
                                 "noise_rate": 0.005}}


def test_same_seed_same_bits():
    a, b = Founders(CFG, 2**33 + 5, "cpu"), Founders(CFG, 2**33 + 5, "cpu")
    assert torch.equal(a.F, b.F)
    assert torch.equal(a.panel(50), b.panel(50))
    assert torch.equal(a.queries(7, 3), b.queries(7, 3))


def test_seeds_and_streams_differ():
    a, b = Founders(CFG, 1, "cpu"), Founders(CFG, 2, "cpu")
    assert not torch.equal(a.panel(50), b.panel(50))
    assert not torch.equal(a.queries(7, 0), a.queries(7, 1))
    assert not torch.equal(a.queries(50, 0), a.panel(50))


def test_a_stream_drawn_alone_is_the_same():
    f = Founders(CFG, 9, "cpu")
    q = [f.queries(5, b) for b in range(3)]
    assert torch.equal(Founders(CFG, 9, "cpu").queries(5, 2), q[2])


def test_mosaic_shape_and_alleles():
    f = Founders(CFG, 4, "cpu")
    X = f.panel(64)
    assert X.shape == (64, 300) and X.dtype == torch.uint8
    assert int(X.max()) <= 1
    # mosaics of 20 founders: most sites of a row equal some founder's
    same = (X[:, None, :] == f.F[None]).float().mean(2).max(1).values
    assert float(same.min()) > 0.5


def test_beta_draws():
    v = beta_02_08(20000, generator(torch.device("cpu"), 3, "beta"), "cpu")
    assert float(v.min()) >= 0 and float(v.max()) <= 1
    assert abs(float(v.mean()) - 0.2) < 0.01       # beta(0.2, 0.8): mean 0.2


def _runs(E: np.ndarray) -> np.ndarray:
    """L[k, j]: the sites from j on that row k of E matches without a break."""
    L = np.zeros((E.shape[0], E.shape[1] + 1), np.int64)
    for j in range(E.shape[1] - 1, -1, -1):
        L[:, j] = (L[:, j + 1] + 1) * E[:, j]
    return L


@pytest.mark.parametrize("switch,noise", [(0.0, 0.04), (0.01, 0.0)])
def test_mosaic_draws_its_assumed_rates(switch, noise):
    """A mosaic differs from its one founder at the noise rate, and a mosaic
    without noise is made of as many founder segments as its switches to
    another founder give (the fewest segments that cover it, found
    greedily)."""
    cfg = {"sites": 4000, "assumed": {"founders": 20, "switch_rate": switch,
                                      "noise_rate": noise}}
    f = Founders(cfg, 2**32 + 17, "cpu")
    X, F = f.panel(60).numpy(), f.F.numpy()
    K, N = F.shape
    if noise:
        got = (X[:, None, :] != F[None]).mean(2).min(1).mean()
        assert abs(got - noise) < 0.1 * noise
        return
    segments = 0
    for row in X:
        L, j = _runs(F == row[None]), 0
        while j < N:
            j += int(L[:, j].max())
            segments += 1
    want = len(X) * (1 + switch * (1 - 1 / K) * (N - 1))
    assert 0.85 * want < segments <= 1.05 * want
