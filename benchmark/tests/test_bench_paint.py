"""The painting cell (``kgp3.paint``) at toy size on the CPU: it runs
correct traced and untraced, its control and planted faults fail its
checks, and its roofline's pair count is the program's. When this module
is imported, its configuration's toy size is added to the ``tiny``
fixture's ``TINY_CONFIGS``, and the cell's two per-layer metrics that read
only a card's trace to the program spans test's ``CARD_ONLY``."""

import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.conftest import EXTEND
from benchmark.rooflines import k6_paint_accumulate as roof
from conftest import TINY_CONFIGS

# the configuration at the kgp3 configuration's toy size
PAINT_TINY = {"kgp3_paint": {"haplotypes": 120, "sites": 320}}
EXTEND["TINY_CONFIGS"].update(PAINT_TINY)
for name, size in PAINT_TINY.items():
    TINY_CONFIGS.setdefault(name, size)
# K6's kernels and the card's idle share are in a card's trace alone
PAINT_CARD_ONLY = {"k6_paint_accumulate.roofline_pct", "device_idle_pct.paint"}
EXTEND["CARD_ONLY"] |= PAINT_CARD_ONLY

CELL = "kgp3.paint"
SEED = 2**31 + 43


def run(base, traced=False, control=False):
    return harness.run_cell(harness.load_cell(CELL, base), SEED, 0.3, traced,
                            torch.device("cpu"), 0.0,
                            log=lambda *a, **k: None, control=control)


def failed(checks):
    return {n for n, c in checks.items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("traced", [False, True])
def test_cell_runs_correct(tiny, traced):
    res = run(tiny, traced)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["checks"]) == {"table_rel_gap", "nregions_differing",
                                  "file_rows_differing", "nothing_compared"}
    assert res["checks"]["table_rel_gap"]["value"] < 1e-12
    metrics = set(res["metrics"])
    if traced:
        assert metrics == {"ops.setup_s", "ops.paint_collect_ms",
                           "ops.paint_write_ms"}
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        assert metrics == {"hap_sites_per_s", "setup_s"}


def test_control_fails_by_the_gap(tiny):
    """The reference in float32 in the program's place: its tables leave
    the gap's limit, nothing else does."""
    res = run(tiny, control=True)
    assert res["correct"], res["checks"]
    assert res["control"]["table_rel_gap"]["value"] > 1e-10
    assert failed(res["control"]) == {"table_rel_gap"}


def own_individual_weighed(mp):
    """The tables made at ploidy 1 and summed over each individual's
    haplotypes: the other haplotype of a recipient's individual weighs."""
    from pbwt_tpu_torch.ops import paint
    real = paint.paint_tables_device

    def tables(sj, ss, se, off, M, N, ploidy, cpr, device=None):
        got = real(sj, ss, se, off, M, N, 1, cpr, device=device)
        n = M // ploidy
        return (*(t.reshape(n, ploidy, n, ploidy).sum((1, 3)) for t in got[:4]),
                got[4].reshape(n, ploidy).sum(1))
    mp.setattr(paint, "paint_tables_device", tables)


def start_off_by_one(mp):
    """Every segment's start one site later, where it stays below its
    end."""
    from pbwt_tpu_torch.ops import paint
    real = paint.paint_tables_device

    def tables(sj, ss, se, off, *args, **kwargs):
        later = np.where(ss + 1 < se, ss + 1, ss).astype(np.int32)
        return real(sj, later, se, off, *args, **kwargs)
    mp.setattr(paint, "paint_tables_device", tables)


def misprinted(mp):
    """The printer's rows of one table a ten-thousandth off."""
    from pbwt_tpu_torch.core import native
    real = native.write_f4_rows
    calls = []

    def rows(table, heads, f):
        calls.append(1)
        return real(table + 1e-4 if len(calls) % 4 == 2 else table, heads, f)
    mp.setattr(native, "write_f4_rows", rows)


@pytest.mark.parametrize("fault,check", [
    (own_individual_weighed, "table_rel_gap"),
    (start_off_by_one, "table_rel_gap"),
    (misprinted, "file_rows_differing"),
])
def test_fault_fails(tiny, monkeypatch, fault, check):
    fault(monkeypatch)
    res = run(tiny)
    assert not res["correct"]
    assert check in failed(res["checks"]), res["checks"]


def panel_segments(seed, M, N):
    from pbwt_tpu_torch.algos import paint
    from pbwt_tpu_torch.core.pbwt import PBWT
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((4, N)) < 0.4).astype(np.uint8)
    src = rng.randint(4, size=M)
    X = np.empty((M, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(M) < 0.05
        src[sw] = rng.randint(4, size=int(sw.sum()))
        X[:, k] = F[src, k]
    return tuple(np.array(c) for c in
                 paint._collect_match_arrays(PBWT.from_haplotypes(X)))


def hand_segments(seed, M, N, empty=(), tail=()):
    """Random segments a recipient in ascending end: none for those of
    `empty`; those of `tail` end before N - 5 (the window then rests on
    the last one)."""
    rng = np.random.RandomState(seed)
    cols, off = [], [0]
    for i in range(M):
        n = 0 if i in empty else rng.randint(1, 12)
        top = N - 5 if i in tail else N
        s = rng.randint(0, top - 1, size=n)
        e = np.minimum(s + rng.randint(1, N // 2, size=n), top)
        order = np.argsort(e, kind="stable")
        cols.append(np.stack([rng.randint(0, M, size=n), s, e])[:, order])
        off.append(off[-1] + n)
    sj, ss, se = (np.ascontiguousarray(c, np.int32)
                  for c in np.concatenate(cols, axis=1))
    return sj, ss, se, np.asarray(off, np.int64)


@pytest.mark.parametrize("segs,M,N,ploidy", [
    (lambda: panel_segments(1, 40, 120), 40, 120, 2),
    (lambda: panel_segments(2, 33, 90), 33, 90, 1),
    (lambda: hand_segments(3, 30, 60, (3, 17), (0, 5, 11, 20)), 30, 60, 2),
])
def test_roofline_pairs_are_the_programs(segs, M, N, ploidy):
    """The roofline's plain count of weighed pairs equals the program's
    ``covering_pairs`` on the same segments."""
    from pbwt_tpu_torch.ops import paint
    sj, ss, se, off = (torch.from_numpy(a) for a in segs())
    want = paint.covering_pairs(off, sj, ss, se, N, ploidy)
    assert int(roof.covering_pairs(off, sj, ss, se, N, ploidy)) == want > 0


def test_roofline_bound_by_operations():
    """At about the cell's shape (511,053,798 weighed pairs and 10,357,849
    segments at 5,008 x 16,384) the bound is the f64 pipe's: 29
    operations a pair at 16.75e12/s, about 0.885 ms."""
    b, ops = roof.work(511_053_798, 5008, 10_357_849, 2)
    assert ops == 29 * 511_053_798 and b / 3.35e12 < ops / 16.75e12
    assert round(1e3 * roof.bound(511_053_798, 5008, 10_357_849, 2), 3) == 0.885


def test_toy_size_reaches_the_fixture():
    """Every configuration of BENCHMARK.json has a toy size in the table
    that the ``tiny`` fixture cuts it to, this module's among them."""
    assert TINY_CONFIGS["kgp3_paint"] == PAINT_TINY["kgp3_paint"]
    assert harness.load_cell(CELL).entry["config"] in TINY_CONFIGS
    assert {c["name"] for c in harness.load_json(
        f"{harness.ROOT}/BENCHMARK.json")["configs"]} <= set(TINY_CONFIGS)


def test_card_only_metrics_reach_the_spans_test():
    """The addition is in the table that benchmark/conftest.py extends the
    spans test's CARD_ONLY from, and there once that module was collected
    beside this one."""
    assert PAINT_CARD_ONLY <= EXTEND["CARD_ONLY"]
    spans = sys.modules.get("test_bench_program_spans")
    if spans is not None:
        assert PAINT_CARD_ONLY <= spans.CARD_ONLY
