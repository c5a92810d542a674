"""The port's matcher on the CPU (plain twins of K2 and K3) against the JAX
package's DeviceMatcher, stage by stage: the panel trajectory, the query
scan on the JAX-built trajectory, and the rows of a whole match, in order.
The data is that of tests/test_match_device.py's trajectory test."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbwt_tpu.ops import match_jax
from pbwt_tpu_torch.ops import convert, match

torch.set_num_threads(1)

M, N = 300, 96


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


def queries(Xp, Q, seed):
    r = np.random.RandomState(seed)
    Xq = np.empty((Q, Xp.shape[1]), np.uint8)
    for q in range(Q):
        pos = 0
        while pos < Xp.shape[1]:
            seg = r.randint(10, 40)
            Xq[q, pos:pos + seg] = Xp[r.randint(0, Xp.shape[0]),
                                      pos:pos + seg]
            pos += seg
    return Xq


@pytest.fixture(scope="module")
def jax_matcher():
    """One JAX matcher for the file (its CPU compile dominates the cost)."""
    Xp = mosaic(5, M, N)
    Xp[11] = Xp[200]                   # duplicate rows: wide intervals
    return Xp, match_jax.DeviceMatcher(Xp)


def _trajectory_from_jax(jm):
    A_all, D8, _, U8, C = (np.asarray(x) for x in jm.traj)
    A, D, U, Cc = convert.trajectory_from_jax(A_all[-1], A_all[:-1], D8, U8,
                                              C)
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in (A, D, U, Cc))


def test_panel_trajectory_matches_jax(jax_matcher):
    _, jm = jax_matcher
    W = torch.from_numpy(np.array(jm.W_all))
    Mp = W.shape[1]
    a0 = torch.arange(Mp, dtype=torch.int32)
    d0 = torch.zeros(Mp, dtype=torch.int32)
    d0[0] = 1
    got = match.panel_trajectory(W, a0, d0)
    for g, r in zip(got, _trajectory_from_jax(jm)):
        assert torch.equal(g, r)


def test_scan_on_jax_trajectory_matches_jax(jax_matcher):
    """K3's twin on the JAX-built tables against match_scan_indexed."""
    Xp, jm = jax_matcher
    Xq = queries(Xp, 20, 1)
    A, D, U, C = _trajectory_from_jax(jm)
    Mp, Q = jm.Mp, Xq.shape[0]
    xq_words = match.pack_row_words(Xq, jm.nw)
    xq_d = jnp.asarray(xq_words)
    A_all, D8, DR, U8, C8 = jm.traj
    (e_j, f_j, g_j), recbuf, nrec = match_jax.match_scan_indexed(
        U8, D8, DR, A_all, C8,
        match_jax._qcols_from_words(xq_d, ns=U.shape[0]), xq_d,
        jm.xp_words, jnp.zeros(Q, jnp.int32), jnp.zeros(Q, jnp.int32),
        jnp.full(Q, Mp, jnp.int32), cap=1 << 17)
    e, f, g, rec, nrec_t = match.match_scan_indexed(
        U, D, A, C, torch.from_numpy(xq_words),
        torch.from_numpy(np.array(jm.xp_words)),
        torch.zeros(Q, dtype=torch.int32), torch.zeros(Q, dtype=torch.int32),
        torch.full((Q,), Mp, dtype=torch.int32), cap=1 << 12)
    n = int(nrec_t)
    assert n == int(nrec) and 0 < n <= 1 << 12
    rec = match.sort_records(rec, n, Q).numpy()
    ref = np.asarray(recbuf)[:n]
    assert np.array_equal(rec[:, 0] * Q + rec[:, 1], ref[:, 0])
    assert np.array_equal(rec[:, 2:], ref[:, 1:])
    for got, want in ((e, e_j), (f, f_j), (g, g_j)):
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_matcher_rows_match_jax(jax_matcher):
    """Whole matches, one port matcher across batches of two widths."""
    Xp, jm = jax_matcher
    tm = match.DeviceMatcher(Xp, device="cpu")
    for Q, seed in [(20, 1), (7, 2)]:
        Xq = queries(Xp, Q, seed)
        rows = tm.match(Xq)
        assert len(rows) > Q
        assert np.array_equal(rows, np.asarray(jm.match(Xq)))


def test_record_overflow_reruns(jax_matcher):
    """A record buffer too small for the batch is detected and the scan is
    run again larger, with the same rows."""
    Xp, _ = jax_matcher
    Xq = queries(Xp, 7, 2)
    want = match.DeviceMatcher(Xp, device="cpu").match(Xq)
    tm = match.DeviceMatcher(Xp, device="cpu")
    tm._caps[7] = 4
    assert np.array_equal(tm.match(Xq), want)
    assert tm._caps[7] > 4


def test_from_pbwt_equals_dense(jax_matcher):
    from pbwt_tpu.core.pbwt import PBWT
    Xp, _ = jax_matcher
    Xq = queries(Xp, 7, 3)
    p = PBWT.from_haplotypes(Xp[:, :90])          # ragged vs chunk_sites
    stream = match.DeviceMatcher.from_pbwt(p, device="cpu", chunk_sites=32)
    dense = match.DeviceMatcher(Xp[:, :90], device="cpu")
    assert np.array_equal(stream.match(Xq[:, :90]), dense.match(Xq[:, :90]))


def test_over_budget_panel_raises(monkeypatch):
    monkeypatch.setattr(match, "TRAJ_BYTES", 1000)
    with pytest.raises(ValueError, match="segmented matcher"):
        match.DeviceMatcher(np.zeros((10, 40), np.uint8), device="cpu")


def test_trajectory_through_port_padding_matches_jax(jax_matcher):
    """A ragged panel (300 rows) through the port's own padding, to a
    multiple of 2,048 with copies of row 0, and the JAX matcher's, to its
    own width: the pad rows sit in one run behind row 0 in both, so with
    them taken out the prefix arrays agree at every site, and so do the
    zero counts less the pad rows'."""
    Xp, jm = jax_matcher
    tm = match.DeviceMatcher(Xp, device="cpu")
    assert tm.Mp == 2048 and tm.Mp != jm.Mp
    A_j, _, _, C_j = _trajectory_from_jax(jm)
    Ns = A_j.shape[0] - 1
    assert tm.A.shape == (Ns + 1, tm.Mp)
    for k in range(Ns + 1):
        assert torch.equal(tm.A[k][tm.A[k] < M], A_j[k][A_j[k] < M])
    x0 = np.zeros(Ns, np.int64)
    x0[:N] = Xp[0] == 0
    x0[N:] = 1                            # pad sites are zero bits
    real_t = tm.C.numpy() - (tm.Mp - M) * x0
    real_j = C_j.numpy() - (jm.Mp - M) * x0
    assert np.array_equal(real_t, real_j)


def test_matcher_trajectory_is_one_wrapper_call(jax_matcher, monkeypatch):
    """DeviceMatcher builds its tables through the multi-site wrapper, once
    a panel, and never through the per-site step."""
    Xp, _ = jax_matcher
    calls = []
    real = match.ad_trajectory
    monkeypatch.setattr(match, "ad_trajectory",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    tm = match.DeviceMatcher(Xp, device="cpu")
    assert calls == [(tm.Ng, tm.Mp)]
