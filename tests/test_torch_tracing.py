"""The port's spans and counters (pbwt_tpu_torch.tracing), on the CPU: totals
and counters always, per-call records and profiler events only while a
torch.profiler runs, self time, and the spans and counters that the matcher,
the block build and the copy model open, held to what those calls return."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbwt_tpu_torch import tracing
from pbwt_tpu_torch.algos import likelihood as algos_ll
from pbwt_tpu_torch.core.pbwt import PBWT
from pbwt_tpu_torch.ops import build, kernels
from pbwt_tpu_torch.ops import likelihood as ls
from pbwt_tpu_torch.ops import match


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _nested(pause=0.002):
    with tracing.span("outer"):
        time.sleep(pause)
        with tracing.span("inner"):
            time.sleep(pause)
            with tracing.span("leaf"):
                time.sleep(pause)
        with tracing.span("inner"):
            time.sleep(pause)
        tracing.count("things", 3)
    tracing.count("things")


def _panel(seed, M, N, founders=5, switch=0.05):
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((founders, N)) < 0.4).astype(np.uint8)
    src = rng.randint(founders, size=M)
    X = np.empty((M, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(M) < switch
        src[sw] = rng.randint(founders, size=int(sw.sum()))
        X[:, k] = F[src, k]
    return X


def _no_record_function(monkeypatch):
    """record_function raising wherever the port would open one."""
    def refuse(*a, **k):
        raise AssertionError("record_function opened with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_without_a_profiler_totals_but_no_records(monkeypatch):
    _no_record_function(monkeypatch)
    _nested()
    tot = tracing.totals()
    assert [tot[n].calls for n in ("inner", "leaf", "outer")] == [2, 1, 1]
    assert tracing.counters() == {"things": 4}
    assert tracing.RECORDS == [] and tracing.records() == []


def test_under_a_profiler_events_nest_as_the_spans():
    with _profiled() as prof:
        _nested()
        _nested()
    recs = tracing.records()
    assert [r.name for r in recs] == ["leaf", "inner", "inner", "outer"] * 2
    by_id = {r.id: r for r in recs}
    for r in recs:
        want = {"outer": None, "inner": "outer", "leaf": "inner"}[r.name]
        assert (by_id[r.parent].name if r.parent else None) == want
        top = r
        while top.parent is not None:
            top = by_id[top.parent]
        assert r.root == top.id and top.name == "outer"
    assert len({r.root for r in recs}) == 2
    events = [e for e in prof.events() if e.name in ("outer", "inner", "leaf")]
    assert sorted(e.name for e in events) == sorted(r.name for r in recs)
    for e in events:
        want = {"outer": None, "inner": "outer", "leaf": "inner"}[e.name]
        got = e.cpu_parent
        assert (got.name if got is not None else None) == want


def test_self_time_is_duration_less_children():
    with _profiled():
        _nested()
    recs = tracing.records()
    for r in recs:
        children = sum(c.seconds for c in recs if c.parent == r.id)
        assert r.self_s == pytest.approx(r.seconds - children, abs=1e-12)
    tot = tracing.totals()
    assert tot["outer"].self_s == pytest.approx(
        tot["outer"].seconds - tot["inner"].seconds, abs=1e-9)
    assert tot["inner"].self_s == pytest.approx(
        tot["inner"].seconds - tot["leaf"].seconds, abs=1e-9)
    assert tot["outer"].root_s == tot["outer"].seconds
    assert tot["inner"].root_s == tot["leaf"].root_s == 0.0
    assert tot["outer"].self_s >= 0.0015


def test_records_of_a_window():
    with _profiled():
        _nested()
        mid = time.perf_counter()
        _nested()
    assert len(tracing.records("inner")) == 4
    assert len(tracing.records("inner", t0=mid)) == 2
    assert len(tracing.records(t1=mid)) == 4


def test_spans_of_several_threads_lose_nothing():
    """Each thread's spans and counters, summed, with the interpreter
    switching threads as often as it can."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(500):
                with tracing.span("t.outer"):
                    with tracing.span("t.inner"):
                        tracing.count("t.n", 2)
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    tot = tracing.totals()
    assert tot["t.outer"].calls == tot["t.inner"].calls == 16 * 500
    assert tot["t.inner"].root_s == 0.0
    assert tracing.counters()["t.n"] == 2 * 16 * 500


def test_write_tsv(tmp_path):
    _nested()
    tracing.write_tsv(str(tmp_path / "s.tsv"))
    lines = (tmp_path / "s.tsv").read_text().splitlines()
    assert lines[0] == "kind\tname\tcalls\tseconds\tself_seconds"
    rows = [ln.split("\t") for ln in lines[1:]]
    assert [r[:3] for r in rows if r[0] == "span"] == [
        ["span", "inner", "2"], ["span", "leaf", "1"], ["span", "outer", "1"]]
    assert ["counter", "things", "4"] in rows


class _FakeLibrary:
    """A kernel library whose entries launch nothing and return 0."""

    def __getattr__(self, name):
        return lambda *args: 0


@pytest.mark.parametrize("profiled", [False, True])
def test_kernel_launch_is_a_span_and_still_counted(monkeypatch, profiled):
    monkeypatch.setattr(kernels, "library", lambda: _FakeLibrary())
    n0 = dict(kernels.LAUNCHES)
    args = [0] * len(kernels._SIGNATURES["k3_rank_plane"])
    if profiled:
        with _profiled() as prof:
            with tracing.span("caller"):
                kernels.launch("k3_rank_plane", *args)
        names = [e.name for e in prof.events()]
        assert "k3_rank_plane" in names
        (rec,) = tracing.records("k3_rank_plane")
        assert tracing.records("caller")[0].id == rec.parent == rec.root
    else:
        _no_record_function(monkeypatch)
        kernels.launch("k3_rank_plane", *args)
        columns = kernels._SIGNATURES["k2_partition_ad_columns"]
        kernels.launch("k2_partition_ad_columns", *[0] * len(columns))
    assert kernels.LAUNCHES["k3_rank_plane"] == n0["k3_rank_plane"] + 1
    assert tracing.totals()["k3_rank_plane"].calls == 1
    if not profiled:
        assert (kernels.LAUNCHES["k2_partition_ad_step"]
                == n0["k2_partition_ad_step"] + 1)
        assert tracing.totals()["k2_partition_ad_columns"].calls == 1
    with pytest.raises(TypeError):
        kernels.launch("k3_rank_plane", 0)
    assert kernels.LAUNCHES["k3_rank_plane"] == n0["k3_rank_plane"] + 1


MATCH_SPANS = {"ops.match", "ops.match.pack", "ops.match.upload",
               "ops.match.scan", "ops.match.sort", "ops.match.expand",
               "ops.match.filter", "ops.match.download"}


@pytest.mark.parametrize("budget", [None, 1])
def test_matcher_spans_and_counters(monkeypatch, budget):
    """Standing, and walked a group of sites a segment (budget 1)."""
    if budget:
        monkeypatch.setattr(match, "TRAJ_BYTES", budget)
        monkeypatch.delenv("PBWT_TORCH_TRAJ_BYTES", raising=False)
    Xp = _panel(5, 60, 96)
    Xq = _panel(6, 7, 96)
    recs_out = []
    real = match.match_scan_indexed
    monkeypatch.setattr(match, "match_scan_indexed", lambda *a: (
        lambda out: recs_out.append(int(out[4])) or out)(real(*a)))
    m = match.DeviceMatcher(Xp, device="cpu")
    assert {"setup.matcher", "setup.matcher.pack", "setup.matcher.upload",
            "setup.matcher.tables"} <= set(tracing.totals())
    with _profiled():
        rows = m.match(Xq)
        rows2 = m.match(Xq[:3])
    tot, cnt = tracing.totals(), tracing.counters()
    assert MATCH_SPANS <= set(tot)
    assert ("ops.match.tables" in tot) == bool(budget)
    assert tot["ops.match"].calls == 2
    assert cnt["ops.match.queries"] == 10
    assert cnt["ops.match.rows"] == len(rows) + len(rows2)
    assert cnt["ops.match.download_bytes"] == rows.nbytes + rows2.nbytes
    assert cnt["ops.match.records"] == sum(recs_out)
    assert cnt["ops.match.segments"] == 2 * m.nseg == len(recs_out)
    assert "ops.match.cap_reruns" not in cnt
    roots = tracing.records("ops.match")
    assert len(roots) == 2
    for r in tracing.records():
        if r.name.startswith("ops.match."):
            assert r.root in {x.id for x in roots}


def test_a_small_cap_is_counted_as_a_rerun():
    Xp = _panel(7, 60, 64)
    Xq = _panel(8, 6, 64)
    want = match.DeviceMatcher(Xp, device="cpu").match(Xq)
    m = match.DeviceMatcher(Xp, device="cpu")
    m._caps[len(Xq)] = 1
    tracing.reset()
    got = m.match(Xq)
    assert np.array_equal(got, want)
    assert tracing.counters()["ops.match.cap_reruns"] == 1
    assert tracing.totals()["ops.match.scan"].calls == 2


def test_block_build_spans_and_counters():
    """A block's stages are children of its ``ops.build.add``, the yz
    bytes' download a child of its encoding, and the counters sum the
    blocks. ``ops.build.card_packs`` and ``ops.build.card_encodes`` are
    counted only on the card, where k1_pack_columns and k1_encode_columns
    launch: here, on the CPU, they are absent."""
    M, N = 70, 100
    X = _panel(9, M, N)
    bb = build.BlockBuild(M, device="cpu")
    with _profiled():
        for s in (0, 64):
            bb.add(np.ascontiguousarray(X[:, s:s + 64].T))
        yz, a = bb.finish()
    want_yz, want_a, _ = build.build_pbwt_device(X, device="cpu")
    assert yz == want_yz and np.array_equal(a, want_a)
    tot, cnt = tracing.totals(), tracing.counters()
    for name in ("ops.build.add", "ops.build.pack", "ops.build.upload",
                 "ops.build.scan", "ops.build.encode"):
        assert tot[name].calls == 2, name
    # encode_columns downloads yz, build_pbwt_device's call too
    assert tot["ops.build.download"].calls == 3
    assert tot["ops.build.finish"].calls == 1
    assert cnt == {"ops.build.sites": N, "ops.build.hap_sites": N * M,
                   "ops.build.yz_bytes": len(yz)}
    adds = tracing.records("ops.build.add")
    enc = tracing.records("ops.build.encode")
    assert [e.parent for e in enc] == [a.id for a in adds]
    assert [d.parent for d in tracing.records("ops.build.download")] == [
        e.id for e in enc]


def test_copy_model_spans_and_counter(monkeypatch):
    X = _panel(10, 12, 20)
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    evaluate = algos_ll.copy_ll_evaluator(PBWT.from_haplotypes(X))
    assert tracing.totals()["setup.ls_columns"].calls == 1
    cols = ls.upload_columns(X, "cpu")
    with _profiled():
        got = [evaluate(0.05, 0.01), ls.copy_ll_columns(cols, 0.05, 0.01)]
    assert got[0] == got[1] and np.isfinite(got[0])
    tot = tracing.totals()
    for name in ("ops.ls.eval", "ops.ls.launch", "ops.ls.download",
                 "ops.ls.sum"):
        assert tot[name].calls == 2, name
    assert tracing.counters()["ops.ls.evals"] == 2
    first, second = tracing.records("ops.ls.eval")
    assert {r.root for r in tracing.records()
            if r.name.startswith("ops.ls.")} == {first.id, second.id}


def _match_path():
    match.DeviceMatcher(_panel(11, 40, 64), device="cpu").match(
        _panel(12, 3, 64))


def _build_path():
    bb = build.BlockBuild(40, device="cpu")
    bb.add(np.ascontiguousarray(_panel(13, 40, 40).T))
    bb.finish()


def _copy_model_path():
    ls.copy_ll_columns(ls.upload_columns(_panel(14, 8, 10), "cpu"), 0.1, 0.1)


@pytest.mark.parametrize("path", [_match_path, _build_path, _copy_model_path])
def test_no_record_function_without_a_profiler(monkeypatch, path):
    _no_record_function(monkeypatch)
    path()
    assert tracing.totals() and tracing.RECORDS == []
