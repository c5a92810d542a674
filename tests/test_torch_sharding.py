"""The port's sharded paths (pbwt_tpu_torch.parallel) over gloo on the CPU,
at world sizes 2 and 4, against the JAX package's sharded build on its 8
virtual CPU devices (tests/conftest.py), the host engines and the port's
single-device paths: the haplotype-sharded build, query-sharded matching and
recipient-sharded painting, all exact. The ranks are spawned once for each
world size; they import the port and nothing of JAX, whose references run
here in the parent. Kernel K7's plain twin is held site by site against the
JAX formulas (pbwt_tpu/parallel/sharding.py:67-75)."""

import numpy as np
import pytest
import torch

from pbwt_tpu_torch import parallel
from pbwt_tpu_torch.core import engine as port_engine
from pbwt_tpu_torch.ops import build, kernels, match, paint
from pbwt_tpu_torch.ops import sharding as ops_sharding
from pbwt_tpu_torch.parallel import dryrun, query_sharding, sharding

torch.set_num_threads(1)

MP = 256                       # rows: a multiple of 32 x 8, 32 x 4, 32 x 2
BUILDS = {"48x30": (0, 48, 30), "48x45": (3, 48, 45)}   # test_sharding.py
MATCH = (96, 70)               # tests/test_sharding.py:55-99
PAINTS = {"ploidy2": (18, 120, 2, 3, 8), "ploidy1": (13, 90, 1, 4, 9)}


def rand_haps(seed, M, N, maf=0.3):
    rng = np.random.RandomState(seed)
    return (rng.random_sample((M, N)) < maf).astype(np.uint8)


def match_data():
    """tests/test_sharding.py's panel and 16 queries."""
    rng = np.random.RandomState(5)
    M, N = MATCH
    Xp = rand_haps(5, M, N, 0.4)
    Xq = np.empty((16, N), np.uint8)
    for q in range(16):
        pos = 0
        while pos < N:
            seg = rng.randint(10, 30)
            src = rng.randint(0, M)
            Xq[q, pos:pos + seg] = Xp[src, pos:pos + seg]
            pos += seg
    return Xp, Xq


def paint_data(name):
    M, N, ploidy, cpr, seed = PAINTS[name]
    X = dryrun.mosaic_queries(rand_haps(seed, 5, N, 0.4), M, seed, 5, 25)
    return dryrun.host_segments(X), M, N, ploidy, cpr


def jobs():
    out = []
    for seed, M, N in BUILDS.values():
        W = build.pack_group_words(rand_haps(seed, M, N), MP)
        out += [("build", W, True, N), ("build", W, False, None),
                ("pbwt", rand_haps(seed, M, N))]
    Xp, Xq = match_data()
    out += [("match", Xp, Xq), ("match", Xp, Xq[:15])]
    for name in PAINTS:
        segs, M, N, ploidy, cpr = paint_data(name)
        out.append(("paint", *segs, M, N, ploidy, cpr))
    return out


JOB = {f"{k}/{v}": 3 * i + j for i, k in enumerate(BUILDS)
       for j, v in enumerate(("divergence", "plain", "pbwt"))}
JOB.update({"match16": 6, "match15": 7, "paint/ploidy2": 8,
            "paint/ploidy1": 9})


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request):
    """Every job on a world of 2 or 4 gloo ranks on the CPU, spawned once."""
    world = request.param
    res = parallel.spawn(world, "gloo", dryrun.rank_jobs, jobs(),
                         device="cpu", threads=1, timeout_s=300)
    assert len(res) == world
    return world, res


_JAX = {}


def jax_build(name, with_divergence):
    """pbwt_tpu.parallel.sharding on 8 virtual CPU devices, and its words."""
    key = (name, with_divergence)
    if key not in _JAX:
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        from pbwt_tpu.ops.build import pack_group_words, prepare_columns
        from pbwt_tpu.parallel import sharding as ref
        seed, M, N = BUILDS[name]
        cols, Mp = prepare_columns(rand_haps(seed, M, N), multiple=MP)
        assert Mp == MP
        mesh = ref.make_mesh(8)
        W = pack_group_words(cols)
        W_dev = jax.device_put(jnp.asarray(W),
                               NamedSharding(mesh, P(None, "s")))
        out = ref.build_scan_sharded_grouped(
            W_dev, mesh, with_divergence=with_divergence,
            n_sites=N if with_divergence else None)
        _JAX[key] = (tuple(np.asarray(x) for x in out), np.asarray(W))
    return _JAX[key]


@pytest.mark.parametrize("divergence", ["divergence", "plain"])
@pytest.mark.parametrize("name", sorted(BUILDS))
def test_sharded_build_equals_jax_sharded_build(ranks, name, divergence):
    """sitewords, counts, a_end, d_end equal the JAX package's sharded
    build exactly, on every rank; 45 sites is not a whole group."""
    world, res = ranks
    want, W_jax = jax_build(name, divergence == "divergence")
    seed, M, N = BUILDS[name]
    assert np.array_equal(build.pack_group_words(rand_haps(seed, M, N), MP),
                          W_jax)
    for r in range(world):
        got = res[r][JOB[f"{name}/{divergence}"]]["out"]
        assert len(got) == 4
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and np.array_equal(g, w), r


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_sharded_build_equals_host_and_single_device(ranks, name):
    """The sorted columns, counts and end state (a, d) of the host engine,
    and every output of the single-device build_scan_grouped (its twin)."""
    world, res = ranks
    seed, M, N = BUILDS[name]
    X = rand_haps(seed, M, N)
    sw, counts, a_end, d_end = res[0][JOB[f"{name}/divergence"]]["out"]
    Ysort, zeros, a, d = dryrun.host_build(X)
    assert np.array_equal(build.unpack_columns(sw[:N], M), Ysort)
    assert np.array_equal(counts[:N], zeros)
    assert np.array_equal(a_end[:M], a) and np.array_equal(d_end[:M], d)
    assert d_end[0] == N + 1
    single = build.build_scan_grouped(
        torch.from_numpy(build.pack_group_words(X, MP)),
        torch.arange(MP, dtype=torch.int32), with_divergence=True,
        n_sites=N)
    for g, w in zip((sw, counts, a_end, d_end), single):
        assert np.array_equal(g, w.numpy())


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_pbwt_sharded_equals_host_engine(ranks, name):
    """The yz bytes, aFend and counts of the JAX package's and the port's
    host engine, on every rank (its rows padded to 32 x world)."""
    from pbwt_tpu.core import engine as ref_engine
    world, res = ranks
    X = rand_haps(*BUILDS[name])
    yz_ref, a_ref = ref_engine.build_from_haplotypes(X)
    yz_port, a_port = port_engine.build_from_haplotypes(X)
    assert yz_ref == yz_port
    for r in range(world):
        yz, aF, counts = res[r][JOB[f"{name}/pbwt"]]["out"]
        assert yz == yz_ref and np.array_equal(aF, a_ref)
        assert np.array_equal(counts, (X == 0).sum(0))


def test_build_collective_bytes(ranks):
    """One all-reduce of Mp/8 bytes a site (pad sites too) and one of 4·Mp
    at the end, counted by the group's wrapper on every rank."""
    world, res = ranks
    for name, (_, _, N) in BUILDS.items():
        ns = -(-N // 32) * 32
        for r in range(world):
            for kind in ("divergence", "plain"):
                assert res[r][JOB[f"{name}/{kind}"]]["bytes"] == \
                    ns * MP // 8 + 4 * MP


@pytest.mark.parametrize("Q", [16, 15])
def test_sharded_match_rows_equal_single_matcher_and_jax(ranks, Q):
    """Rows of match_queries_sharded, on every rank, equal
    DeviceMatcher.match (its twins) and the JAX matcher's, row for row;
    15 queries is a batch neither world size divides."""
    world, res = ranks
    Xp, Xq = match_data()
    want = match.DeviceMatcher(Xp, device="cpu").match(Xq[:Q])
    assert len(want) > Q
    if ("match", Q) not in _JAX:
        from pbwt_tpu.ops import match_jax
        _JAX["match", Q] = np.asarray(
            match_jax.DeviceMatcher(Xp).match(Xq[:Q]))
    assert np.array_equal(want, _JAX["match", Q])
    for r in range(world):
        got = res[r][JOB[f"match{Q}"]]["out"]
        assert got.dtype == np.int32 and np.array_equal(got, want), r


@pytest.mark.parametrize("name", sorted(PAINTS))
def test_sharded_paint_equals_single_device(ranks, name):
    """The five tables of paint_tables_sharded, on every rank, equal
    paint_tables_device's (its twin on the CPU) bit for bit, with an odd
    number of individuals; and the host C pass as closely as the twin does
    (f64 in another order: within 1e-12 of each table's largest entry;
    on a card K6 equals the host pass to the bit)."""
    world, res = ranks
    segs, M, N, ploidy, cpr = paint_data(name)
    want = paint.paint_tables_device(*segs, M, N, ploidy, cpr, device="cpu")
    host = dryrun.host_paint(*segs, M, N, ploidy, cpr)
    assert want[0].any() and np.array_equal(want[4], host[4])
    for r in range(world):
        got = res[r][JOB[f"paint/{name}"]]["out"]
        for g, w, h in zip(got, want, host):
            assert np.array_equal(g.view(np.int64), w.view(np.int64)), r
            assert np.abs(g - h).max() <= 1e-12 * max(np.abs(h).max(), 1.0)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(PAINTS))
def test_host_pass_by_shares_of_individuals_is_the_whole(name, world):
    """Why the all-reduce is exact: the host C pass over each rank's share
    of whole individuals (the others' segment ranges empty), the shares
    summed, equals the pass over all of them bit for bit."""
    segs, M, N, ploidy, cpr = paint_data(name)
    sj, ss, se, off = segs
    whole = dryrun.host_paint(*segs, M, N, ploidy, cpr)
    total = [np.zeros_like(t) for t in whole]
    for r in range(world):
        lo, hi = parallel.shard(M, world, r, unit=ploidy)
        s0, s1 = int(off[lo]), int(off[hi])
        part = dryrun.host_paint(sj[s0:s1], ss[s0:s1], se[s0:s1],
                                 np.clip(off, s0, s1) - s0, M, N, ploidy,
                                 cpr)
        for t, p in zip(total, part):
            t += p
    for t, w in zip(total, whole):
        assert np.array_equal(t.view(np.int64), w.view(np.int64))


def test_ranks_launch_no_kernel_on_the_cpu(ranks):
    """CPU tensors take the twins: no rank counted a kernel launch."""
    _, res = ranks
    assert all(job["launches"] == {} for r in res for job in r)


def _jax_fm_step(pos, w, s, colw, Mp):
    """pbwt_tpu/parallel/sharding.py:67-75 on one site's column: (pos', c,
    the ones before every 1,024th position and in all, K7's chunk
    prefix)."""
    import jax
    import jax.numpy as jnp
    colw, pos = jnp.asarray(colw), jnp.asarray(pos)
    y = (jnp.asarray(w) >> s) & 1
    pc = jax.lax.population_count(colw)
    ones_excl = jnp.cumsum(pc) - pc
    c = Mp - ones_excl[-1] - pc[-1]
    within = jax.lax.population_count(
        colw[pos >> 5] & ((jnp.int32(1) << (pos & 31)) - 1))
    u_pos = pos - (ones_excl[pos >> 5] + within)
    pos = jnp.where(y != 0, c + pos - u_pos, u_pos)
    nw = Mp // 32
    ends = sorted(set(range(0, nw, 32)) | {nw})
    ones = np.append(np.asarray(ones_excl), Mp - int(c))
    return np.asarray(pos), int(c), ones[ends]


@pytest.mark.parametrize("world", [1, 3])
def test_fm_step_twin_equals_jax_formulas(world):
    """K7's twin site by site over 64 sites on `world` simulated ranks: the
    contributions scattered at the positions (the first site's alone, the
    others fused into the step before) sum to the column, and pos', the
    zero count and the column's chunk prefix equal the JAX package's
    formulas; the columns are the host engine's sorted columns."""
    import jax.numpy as jnp
    M, N = 32 * 3 * 4, 64
    X = rand_haps(11, M, N)
    X[5] = X[77]
    W = torch.from_numpy(build.pack_group_words(X, M))
    B = M // world
    pos = [torch.arange(r * B, (r + 1) * B, dtype=torch.int32)
           for r in range(world)]
    Wl = [W[:, r * B:(r + 1) * B] for r in range(world)]
    contrib = [torch.zeros(M // 32, dtype=torch.int32) for _ in range(world)]
    before = dict(kernels.LAUNCHES)
    for r in range(world):
        got = ops_sharding.fm_step(pos[r], None, 0, None, M, nxt=contrib[r],
                                   wn=Wl[r][0], s_next=0)
        assert torch.equal(got, pos[r])
    Ysort, zeros = dryrun.host_build(X)[:2]
    for k in range(N):
        colw = sum(c.long() for c in contrib)
        colw = torch.where(colw >= 1 << 31, colw - (1 << 32), colw).to(
            torch.int32)
        assert np.array_equal(build.unpack_columns(colw[None].numpy(), M)[0],
                              Ysort[k])
        nxt = [torch.zeros_like(colw) for _ in range(world)]
        for r in range(world):
            pref = torch.empty(ops_sharding.prefix_len(M), dtype=torch.int32)
            count = torch.empty(1, dtype=torch.int32)
            more = (dict(nxt=nxt[r], wn=Wl[r][(k + 1) // 32],
                         s_next=(k + 1) % 32) if k + 1 < N else {})
            got = ops_sharding.fm_step(pos[r], Wl[r][k // 32], k % 32, colw,
                                       M, count=count, pref=pref, **more)
            want, c, ones = _jax_fm_step(pos[r].numpy(),
                                         Wl[r][k // 32].numpy(), k % 32,
                                         colw.numpy(), M)
            assert np.array_equal(got.numpy(), want)
            assert int(count) == c == zeros[k]
            assert np.array_equal(pref.numpy(), ones)
            pos[r] = got
        contrib = nxt
    assert kernels.LAUNCHES == before


@pytest.mark.parametrize("Mp", [256, 288])
def test_divergence_from_packed_columns(Mp):
    """The replicated divergence as one pass over the packed sorted columns
    (ops/partition.py:ad_columns, K2's twin on the CPU) equals
    build_scan_grouped(with_divergence=True) in a and d, and the JAX
    package's end state (its engine's forwards_ad, pbwtCursorForwardsAD) on
    the real rows, at 45 sites (not a whole group); 288 rows is not a
    multiple of 32 x 2 ranks."""
    from pbwt_tpu.core import engine as ref_engine
    from pbwt_tpu_torch.ops import partition
    M, N = Mp - 13, 45
    X = rand_haps(17, M, N)
    W = torch.from_numpy(build.pack_group_words(X, Mp))
    a0 = torch.arange(Mp, dtype=torch.int32)
    ycols, counts, a_end, d_end = build.build_scan_grouped(
        W, a0, with_divergence=True, n_sites=N)
    d0 = torch.zeros(Mp, dtype=torch.int32)
    d0[0] = 1
    a, d = partition.ad_columns(ycols, a0, d0)
    assert torch.equal(a, a_end) and int(d[0]) == ycols.shape[0] + 1
    d[0] = N + 1
    assert torch.equal(d, d_end)
    a_ref = np.arange(M, dtype=np.int32)
    d_ref = np.zeros(M + 1, dtype=np.int32)
    d_ref[0] = d_ref[M] = 1
    for k in range(N):
        a_ref, d_ref = ref_engine.forwards_ad(a_ref, d_ref, X[a_ref, k], k)
    assert np.array_equal(a[:M].numpy(), a_ref)
    assert np.array_equal(d[:M].numpy(), d_ref[:M])


def test_site_groups_equal_jax_formulas():
    """The sharded build's group function called directly, a world of one
    (its collective the identity) over two groups at 2,112 rows (3 chunks
    of K7's prefix): every column, zero count and position equals the JAX
    package's per-site formulas (pbwt_tpu/parallel/sharding.py:67-75), the
    chunk prefix its ones before every 1,024th position, and the group's
    collective bytes Mp/8 a site."""
    M, Mp, N = 2_100, 2_112, 64
    X = rand_haps(19, M, N)
    W = torch.from_numpy(build.pack_group_words(X, Mp))
    g = parallel.Group("gloo", 0, 1, torch.device("cpu"))
    chase = sharding.SiteGroups(W, g)
    sitewords = torch.zeros((N, Mp // 32), dtype=torch.int32)
    counts = torch.empty(N, dtype=torch.int32)
    pos = np.arange(Mp, dtype=np.int32)
    for grp in range(N // 32):
        chase.run(grp, sitewords, counts)
        for k in range(32 * grp, 32 * grp + 32):
            w = W[k // 32].numpy()
            y = ((w >> (k % 32)) & 1).astype(np.int64)
            colw = np.zeros(Mp // 32, np.int64)
            np.add.at(colw, pos >> 5, y << (pos & 31))
            colw = colw.astype(np.uint32).view(np.int32)
            assert np.array_equal(sitewords[k].numpy(), colw), k
            pos, c, ones = _jax_fm_step(pos, w, k % 32, colw, Mp)
            assert int(counts[k]) == c, k
        assert np.array_equal(chase.pos.numpy(), pos)
        assert np.array_equal(chase.pref.numpy(), ones)
    assert g.bytes == N * Mp // 8
    Ysort = dryrun.host_build(X)[0]
    assert np.array_equal(build.unpack_columns(sitewords.numpy(), M), Ysort)


def test_shard_cuts_whole_units():
    """shard: contiguous, covering, whole units, the earlier ranks no
    smaller."""
    for n, world, unit in ((16, 4, 1), (15, 4, 1), (18, 4, 2), (13, 4, 1),
                           (3, 4, 1), (0, 2, 1), (10, 3, 2)):
        cuts = [parallel.shard(n, world, r, unit) for r in range(world)]
        assert cuts[0][0] == 0 and cuts[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
        assert all(lo % unit == 0 for lo, _ in cuts)
        sizes = [hi - lo for lo, hi in cuts]
        assert max(sizes) - min(sizes) <= unit


def test_nccl_without_cards_raises_naming_gloo(tmp_path):
    """Asking for NCCL with more ranks than cards (here: none) raises and
    names gloo; no group is made and nothing switches backend."""
    import torch.distributed as dist
    for world in (1, 2):
        with pytest.raises(ValueError, match="gloo"):
            parallel.init_group("nccl", 0, world,
                                f"file://{tmp_path}/store{world}")
    with pytest.raises(ValueError, match="expected one of"):
        parallel.init_group("mpi", 0, 1, f"file://{tmp_path}/store")
    assert not dist.is_initialized()


def test_a_failing_rank_fails_the_run():
    """A rank that raises fails spawn with its traceback; the others are
    ended: here every rank's check of its launches (the twins launch
    nothing, so 'K7 at least once' fails)."""
    Xp, Xq = match_data()
    with pytest.raises(RuntimeError, match=r"rank \d of 2 failed") as e:
        parallel.spawn(2, "gloo", dryrun.rank_jobs,
                       [("match", Xp, Xq[:4], {"k7_fm_step": None})],
                       device="cpu", threads=1, timeout_s=120)
    assert "k7_fm_step 0 times, not at least once" in str(e.value)


def test_query_sharding_gathers_rows_in_one_process():
    """A world of one: match_queries_sharded and paint_tables_sharded are
    DeviceMatcher.match and paint_tables_device, and no collective leaves
    the process."""
    g = parallel.Group("gloo", 0, 1, torch.device("cpu"))
    Xp, Xq = match_data()
    m = match.DeviceMatcher(Xp, device="cpu")
    assert np.array_equal(query_sharding.match_queries_sharded(g, m, Xq),
                          m.match(Xq))
    segs, M, N, ploidy, cpr = paint_data("ploidy2")
    got = query_sharding.paint_tables_sharded(g, *segs, M, N, ploidy, cpr)
    want = paint.paint_tables_device(*segs, M, N, ploidy, cpr, device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    W = torch.from_numpy(build.pack_group_words(rand_haps(3, 48, 45), 64))
    out = sharding.build_scan_sharded_grouped(W, g, n_sites=45)
    single = build.build_scan_grouped(W, torch.arange(64, dtype=torch.int32),
                                      with_divergence=True, n_sites=45)
    assert all(torch.equal(a, b) for a, b in zip(out, single))
    rows = len(m.match(Xq))
    n = M // ploidy
    assert g.bytes == 8 + 16 * rows + 4 * 8 * n * n + 8 * n + 64 * 8 + 4 * 64


def test_fm_step_takes_no_other_device_and_launches_are_profiled(
        monkeypatch):
    """fm_step runs its twin only on CPU tensors: on another device it goes
    to the kernel's checks, which refuse it. A launch is a profiler span of
    the kernel's name (what -profile's trace shows)."""
    pos = torch.zeros(32, dtype=torch.int32, device="meta")
    colw = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops_sharding.fm_step(pos, pos, 0, colw, 32)

    class Lib:
        @staticmethod
        def k7_fm_step(*args):
            return 0
    monkeypatch.setattr(kernels, "library", lambda: Lib)
    monkeypatch.setitem(kernels.LAUNCHES, "k7_fm_step", 0)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kernels.launch("k7_fm_step", *[0] * 14)
    assert kernels.LAUNCHES["k7_fm_step"] == 1
    assert "k7_fm_step" in {e.name for e in prof.events()}


def test_graph_replay_counts_its_launches(monkeypatch):
    """kernels.Graph: the capture counts no launch (nothing ran), a replay
    adds the launches the captured function made and is one profiler span
    of the graph's name (CUDA's capture and replay stubbed out here)."""
    import contextlib

    class Lib:
        @staticmethod
        def k7_fm_step(*args):
            return 0

    class FakeGraph:
        def replay(self):
            pass
    monkeypatch.setattr(kernels, "library", lambda: Lib)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, **kw: contextlib.nullcontext())
    monkeypatch.setitem(kernels.LAUNCHES, "k7_fm_step", 5)
    monkeypatch.setattr(kernels, "REPLAYS", {})
    graph = kernels.Graph("group_graph", lambda: [
        kernels.launch("k7_fm_step", *[0] * 14) for _ in range(3)])
    assert kernels.LAUNCHES["k7_fm_step"] == 5
    assert graph.launches == {"k7_fm_step": 3}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        graph.replay()
        graph.replay()
    assert kernels.LAUNCHES["k7_fm_step"] == 11
    assert kernels.REPLAYS == {"group_graph": 2}
    assert [e.name for e in prof.events()].count("group_graph") == 2
