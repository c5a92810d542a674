"""The port's matcher on the CPU (plain twins of K2, k3_rank_plane and K3)
against the JAX package's DeviceMatcher, stage by stage: the panel
trajectory, its rank plane, the query scan on the JAX-built trajectory, and
the rows of a whole match, in order.
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
    plane = match.rank_plane(U, C)
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
        plane, D, A, C, torch.from_numpy(xq_words),
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


def _budget(groups, Mp=2048):
    """A trajectory budget that holds `groups` groups of sites a segment."""
    return match.table_bytes(Mp, groups)


@pytest.mark.parametrize("Q,seed", [(20, 1), (7, 2)])
@pytest.mark.parametrize("groups,nseg", [(3, 1), (2, 2), (1, 3), (0, 3)])
def test_segment_route_rows_match_standing_and_jax(jax_matcher, monkeypatch,
                                                   groups, nseg, Q, seed):
    """A panel over the trajectory budget no longer raises: it is walked in
    segments of whole groups every call, and the rows are those of the
    standing route and of the JAX matcher, in order. Budgets that hold all
    three groups (the standing route), two (segments of 2 + 1), one, and
    not even one (a group a segment all the same)."""
    Xp, jm = jax_matcher
    Xq = queries(Xp, Q, seed)
    want = match.DeviceMatcher(Xp, device="cpu").match(Xq)
    monkeypatch.setenv("PBWT_TORCH_TRAJ_BYTES", str(_budget(groups)))
    tm = match.DeviceMatcher(Xp, device="cpu")
    assert tm.nseg == nseg and tm.nseg * tm.gseg >= tm.Ng == 3
    assert (tm.A is None) == (nseg > 1) == (tm.W is not None)
    rows = tm.match(Xq)
    assert rows.dtype == np.int32 and len(rows) > Q
    assert np.array_equal(rows, want)
    assert np.array_equal(rows, np.asarray(jm.match(Xq)))


def test_segment_route_pad_sites_reuse_and_launches(jax_matcher, monkeypatch):
    """90 sites in segments of one group: the last segment ends in pad
    sites. One matcher serves batches of two widths from one set of tables,
    with one trajectory call, one plane and one scan a segment, each at its
    first site."""
    Xp, _ = jax_matcher
    Xp = np.ascontiguousarray(Xp[:, :90])
    dense = match.DeviceMatcher(Xp, device="cpu")
    batches = [queries(Xp, Q, seed) for Q, seed in [(20, 1), (7, 2)]]
    wants = [dense.match(Xq) for Xq in batches]
    monkeypatch.setattr(match, "TRAJ_BYTES", _budget(1))
    tm = match.DeviceMatcher(Xp, device="cpu")
    assert (tm.nseg, tm.gseg) == (3, 1)
    calls = []
    for name in ("ad_trajectory", "rank_plane", "match_scan_indexed"):
        real = getattr(match, name)
        monkeypatch.setattr(
            match, name, lambda *a, _n=name, _r=real, **kw:
            calls.append((_n, a[3] if _n == "ad_trajectory" else
                          a[10] if _n == "match_scan_indexed" else None))
            or _r(*a, **kw))
    tables = None
    for Xq, want in zip(batches, wants):
        del calls[:]
        assert np.array_equal(tm.match(Xq), want)
        assert calls == [(n, k) for first in (0, 32, 64) for n, k in
                         (("ad_trajectory", first), ("rank_plane", None),
                          ("match_scan_indexed", first))]
        assert tables is None or all(t is u for t, u in
                                     zip(tables, tm._tables))
        tables = tm._tables
    assert tables[0].shape == (33, tm.Mp)


def test_segment_route_record_overflow_reruns(jax_matcher, monkeypatch):
    """A record buffer too small for some segment: the call runs again from
    the first segment with a larger one, to the same rows."""
    Xp, _ = jax_matcher
    Xq = queries(Xp, 7, 2)
    want = match.DeviceMatcher(Xp, device="cpu").match(Xq)
    monkeypatch.setattr(match, "TRAJ_BYTES", _budget(1))
    tm = match.DeviceMatcher(Xp, device="cpu")
    firsts = []
    real = match.match_scan_indexed
    monkeypatch.setattr(match, "match_scan_indexed",
                        lambda *a: firsts.append((a[9], a[10])) or real(*a))
    tm._caps[7] = 4
    assert np.array_equal(tm.match(Xq), want)
    assert tm._caps[7] > 4
    caps = sorted({c for c, _ in firsts})
    assert caps[0] == 4 and len(caps) > 1
    # every cap begins at the first segment; the last one reaches the end
    for c in caps:
        assert [k for cc, k in firsts if cc == c][0] == 0
    assert [k for c, k in firsts if c == caps[-1]] == [0, 32, 64]


def test_segment_route_from_pbwt(jax_matcher, monkeypatch):
    from pbwt_tpu.core.pbwt import PBWT
    Xp, _ = jax_matcher
    Xq = queries(Xp, 7, 3)[:, :90]
    p = PBWT.from_haplotypes(Xp[:, :90])
    want = match.DeviceMatcher(Xp[:, :90], device="cpu").match(Xq)
    monkeypatch.setenv("PBWT_TORCH_TRAJ_BYTES", str(_budget(2)))
    tm = match.DeviceMatcher.from_pbwt(p, device="cpu", chunk_sites=32)
    assert tm.nseg == 2
    assert np.array_equal(tm.match(Xq), want)


def test_scan_and_expansion_from_a_first_site(jax_matcher):
    """K3's twin over the second half of a trajectory from the carried
    (e, f, g), and the expansion of its records against that half's prefix
    arrays, against the whole scan; a first site inside a word is refused."""
    Xp, _ = jax_matcher
    Xq = queries(Xp, 20, 1)
    tm = match.DeviceMatcher(Xp, device="cpu")
    Q, cut = len(Xq), 64
    xq = torch.from_numpy(match.pack_row_words(Xq, tm.Ng))
    start = (torch.zeros(Q, dtype=torch.int32),
             torch.zeros(Q, dtype=torch.int32),
             torch.full((Q,), tm.Mp, dtype=torch.int32))
    whole = match.match_scan_indexed(tm.plane, tm.D, tm.A, tm.C, xq,
                                     tm.xp_words, *start, cap=4096)
    h1 = match.match_scan_indexed(tm.plane[:cut], tm.D[:cut], tm.A[:cut + 1],
                                  tm.C[:cut], xq, tm.xp_words, *start,
                                  cap=4096)
    h2 = match.match_scan_indexed(tm.plane[cut:], tm.D[cut:], tm.A[cut:],
                                  tm.C[cut:], xq, tm.xp_words, *h1[:3],
                                  cap=4096, first_site=cut)
    n, n1, n2 = int(whole[4]), int(h1[4]), int(h2[4])
    assert n == n1 + n2 and n1 > 0 and n2 > 0
    for got, want in zip(h2[:3], whole[:3]):
        assert torch.equal(got, want)
    rec = match.sort_records(whole[3], n, Q)
    rec1, rec2 = (match.sort_records(h[3], m, Q)
                  for h, m in ((h1, n1), (h2, n2)))
    assert torch.equal(torch.cat([rec1, rec2]), rec)
    assert int(rec2[:, 0].min()) >= cut
    rows = match.expand_rows(tm.A, rec, *whole[:3], tm.N)
    parts = [match.expand_rows(tm.A[:cut + 1], rec1, *h1[:3], tm.N,
                               flush=False),
             match.expand_rows(tm.A[cut:], rec2, *h2[:3], tm.N,
                               first_site=cut)]
    assert torch.equal(torch.cat(parts), rows)
    with pytest.raises(ValueError, match="multiple of 32"):
        match.match_scan_indexed(tm.plane[40:], tm.D[40:], tm.A[40:],
                                 tm.C[40:], xq, tm.xp_words, *start,
                                 cap=4096, first_site=40)


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
                        lambda *a, **kw: calls.append(a[0].shape)
                        or real(*a, **kw))
    tm = match.DeviceMatcher(Xp, device="cpu")
    assert calls == [(tm.Ng, tm.Mp)]


def _jax_ranks(seed, Ng, Mp):
    """(U, C) of the JAX package's panel_trajectory over random group words
    with long equal runs, as the port lays them out."""
    rng = np.random.RandomState(seed)
    W = rng.randint(0, 2**32, size=(Ng, Mp), dtype=np.uint32).astype(np.int32)
    W[:, : Mp // 3] = W[:, :1]
    a0 = np.arange(Mp, dtype=np.int32)
    d0 = np.zeros(Mp, np.int32)
    d0[0] = 1
    a_end, A_pre, D8, _, U8, C = match_jax.panel_trajectory(
        jnp.asarray(W), jnp.asarray(a0), jnp.asarray(d0))
    _, _, U, C = convert.trajectory_from_jax(
        *(np.asarray(x) for x in (a_end, A_pre, D8, U8, C)))
    return torch.from_numpy(np.ascontiguousarray(U)), \
        torch.from_numpy(np.ascontiguousarray(C))


def _assert_plane_gives(plane, U, C):
    """Every position 0..Mp of every site reads U, and C at Mp."""
    Ns, Mp = U.shape
    got = match.plane_rank(plane, torch.arange(Mp + 1))
    assert got.shape == (Ns, Mp + 1)
    assert torch.equal(got[:, :Mp], U.long())
    assert torch.equal(got[:, Mp], C.long())


@pytest.mark.parametrize("rows", [2048, 4096])
def test_rank_plane_reads_back_jax_ranks(rows):
    """The rank plane's twin on U and C of the JAX trajectory."""
    U, C = _jax_ranks(rows, 2, rows)
    assert U.shape == (64, rows)
    plane = match.rank_plane(U, C)
    assert plane.shape == (U.shape[0], match.plane_blocks(rows),
                           match.PLANE_WORDS)
    assert plane.dtype == torch.int32
    _assert_plane_gives(plane, U, C)


@pytest.mark.parametrize("blocks", [2, 4, 8])
def test_rank_plane_block_widths(blocks):
    """Tables 2, 4 and 8 blocks wide whose rows end just inside a block, at
    its end (position Mp then has a block to itself) and just beyond it."""
    rows_a_block = 32 * (match.PLANE_WORDS - 1)
    rng = np.random.RandomState(blocks)
    for Mp in (rows_a_block * (blocks - 1) + off for off in (-1, 0, 1)):
        zero = rng.randint(0, 2, size=(40, Mp)).astype(np.int32)
        zero[:, : Mp // 3] = zero[:, :1]
        ranks = np.cumsum(zero, axis=1, dtype=np.int32)
        U = torch.from_numpy(np.ascontiguousarray(ranks - zero))
        C = torch.from_numpy(np.ascontiguousarray(ranks[:, -1]))
        plane = match.rank_plane(U, C)
        assert plane.shape == (40, Mp // rows_a_block + 1, match.PLANE_WORDS)
        _assert_plane_gives(plane, U, C)


def test_rank_plane_through_port_padding(jax_matcher):
    """A ragged panel (300 rows) through the port's own padding: the
    matcher's plane reads back the ranks of its own trajectory at every
    position, and its zero counts, less the pad rows', are the JAX
    trajectory's."""
    Xp, jm = jax_matcher
    tm = match.DeviceMatcher(Xp, device="cpu")
    rev = torch.tensor(match._REV8, dtype=torch.uint8)
    W = rev[tm.xp_words.view(torch.uint8).long()] \
        .view(torch.int32).t().contiguous()
    a0 = torch.arange(tm.Mp, dtype=torch.int32)
    d0 = torch.zeros(tm.Mp, dtype=torch.int32)
    d0[0] = 1
    _, _, U, C = match.panel_trajectory(W, a0, d0)
    assert torch.equal(C, tm.C)
    _assert_plane_gives(tm.plane, U, C)
    # pad rows copy row 0, so rank(Mp) - rank(0..) counts them where row 0
    # is zero: the real rows' zeros are the JAX trajectory's
    _, _, _, C_j = _trajectory_from_jax(jm)
    x0 = np.ones(U.shape[0], np.int64)
    x0[:N] = Xp[0] == 0
    at_mp = match.plane_rank(tm.plane, torch.tensor([tm.Mp]))[:, 0].numpy()
    assert np.array_equal(at_mp - (tm.Mp - M) * x0,
                          C_j.numpy() - (jm.Mp - M) * x0)


def test_matcher_makes_one_plane_a_trajectory(jax_matcher, monkeypatch):
    """DeviceMatcher packs the rank table once a panel, and a batch of
    queries packs nothing."""
    Xp, _ = jax_matcher
    calls = []
    real = match.rank_plane
    monkeypatch.setattr(match, "rank_plane",
                        lambda U, C, *out: calls.append(U.shape)
                        or real(U, C, *out))
    tm = match.DeviceMatcher(Xp, device="cpu")
    assert calls == [(tm.Ng * 32, tm.Mp)]
    tm.match(queries(Xp, 5, 4))
    assert len(calls) == 1 and not hasattr(tm, "U")
