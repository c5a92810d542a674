"""The port's partition wrappers (K1, K2) on the CPU, where they run their
plain-torch twins, against the JAX package's Pallas kernels (interpret mode)
and the host engine. Every comparison is exact: all values are integers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbwt_tpu.core import engine
from pbwt_tpu.ops import partition_pallas as pp
from pbwt_tpu_torch.ops import convert, kernels, partition

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.int32))


def _host_group(w, a):
    """32 stable partitions of (a, w) by bits 0..31 of w, as numpy."""
    cols, counts = [], []
    for s in range(32):
        k = (w >> s) & 1
        cols.append(k.astype(np.uint8))
        counts.append(int((k == 0).sum()))
        order = np.concatenate([np.nonzero(k == 0)[0], np.nonzero(k == 1)[0]])
        a, w = a[order], w[order]
    return a, w, np.array(cols), np.array(counts)


def _edge_words(M):
    return [np.zeros(M, np.int32), np.full(M, -1, np.int32),
            np.tile(np.array([0x55555555, 0], np.int32), M // 2)[:M]]


def test_group_partition_matches_pallas():
    M = 4096
    R = M // 128
    rng = np.random.RandomState(11)
    w_nat = rng.randint(0, 2**32, size=M, dtype=np.uint32).astype(np.int32)
    a0 = rng.permutation(M).astype(np.int32)
    before = dict(kernels.LAUNCHES)
    for w in [w_nat] + _edge_words(M):
        a_t, w_t, ycols, counts = partition.group_partition(_t(w), _t(a0))
        ws = w[a0]                       # JAX takes words in sort order
        a_j, w_j, ywords, cnt_j = pp.group_partition(
            jnp.asarray(ws.reshape(R, 128)), jnp.asarray(a0.reshape(R, 128)),
            interpret=True)
        assert np.array_equal(a_t.numpy(), convert.flat_plane(a_j))
        assert np.array_equal(w_t.numpy(), convert.flat_plane(w_j))
        assert np.array_equal(ycols.numpy(),
                              convert.sitewords_to_ycols(np.asarray(ywords)))
        assert np.array_equal(counts.numpy(), np.asarray(cnt_j))
    assert kernels.LAUNCHES == before    # CPU tensors never reach a kernel


def test_partition_ad_step_matches_pallas():
    M = 4096
    R = M // 128
    rng = np.random.RandomState(5)
    w = rng.randint(0, 2**32, size=M, dtype=np.uint32).astype(np.int32)
    a = rng.permutation(M).astype(np.int32)
    d = rng.randint(0, 9, size=M).astype(np.int32)
    at, dt, wt = _t(a), _t(d), _t(w)
    aj, dj, wj = (jnp.asarray(x.reshape(R, 128)) for x in (a, d, w))
    for k in range(4):
        got = partition.partition_ad_step(at, dt, wt, k, k + 3)
        ref = pp.partition_ad_step(aj, dj, wj, k, k + 3, interpret=True)
        for g, r in zip(got, ref):
            assert np.array_equal(g.numpy(), convert.flat_plane(r))
        at, dt, wt = got[:3]
        aj, dj, wj = ref[:3]


@pytest.mark.parametrize("M", [255, 256, 4097])
def test_partitions_match_engine(M):
    rng = np.random.RandomState(M)
    w = rng.randint(0, 2**32, size=M, dtype=np.uint32).astype(np.int32)
    w[: M // 3] = w[0]                    # long equal runs: deep divergence
    # K1 against the host chain
    a_t, w_t, ycols, counts = partition.group_partition(
        _t(w), torch.arange(M, dtype=torch.int32))
    a_h, w_h, cols_h, counts_h = _host_group(w, np.arange(M, dtype=np.int32))
    assert np.array_equal(a_t.numpy(), a_h)
    assert np.array_equal(w_t.numpy(), w_h)
    bits = np.unpackbits(ycols.numpy().view(np.uint8), axis=1,
                         bitorder="little")[:, :M]
    assert np.array_equal(bits, cols_h)
    assert np.array_equal(counts.numpy(), counts_h)
    # K2 against forwards_ad / calculate_u over 32 sites
    a = np.arange(M, dtype=np.int32)
    d = np.zeros(M + 1, np.int32)
    d[0] = d[M] = 1
    at, dt, wt = _t(a), _t(d[:M]), _t(w)
    ws = w.copy()
    for k in range(32):
        y = ((ws >> k) & 1).astype(np.uint8)
        u, c = engine.calculate_u(y)
        a, d = engine.forwards_ad(a, d, y, k)
        at, dt, wt, ut, cnt = partition.partition_ad_step(at, dt, wt, k, k)
        ws = np.concatenate([ws[y == 0], ws[y == 1]])
        assert np.array_equal(ut.numpy(), u[:M]), k
        assert int(cnt[0]) == c
        assert np.array_equal(at.numpy(), a)
        assert np.array_equal(dt.numpy(), d[:M])
        assert np.array_equal(wt.numpy(), ws)
