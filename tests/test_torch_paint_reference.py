"""The benchmark's plain reference of painting (``benchmark/reference/
paint.py``) against the port on the CPU: its segments against the port's
within-panel collection, its tables against the port's on the twin route and
on the host C route and against the JAX package's; what
``paint_ancestry_matrix`` returns against the files it wrote; and the spans
and counters one paint leaves under a profiler."""

import io
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pbwt_tpu.algos.paint as jax_paint
import pbwt_tpu.core.native as jax_native
import pbwt_tpu.core.pbwt as jax_pbwt
from benchmark.reference import paint as reference
from pbwt_tpu_torch import tracing
from pbwt_tpu_torch.algos import paint as port_paint
from pbwt_tpu_torch.core import native
from pbwt_tpu_torch.core.pbwt import PBWT
from pbwt_tpu_torch.ops import paint as port_device
from pbwt_tpu_torch.utils import set_log_file

TAGS = ("chunkcounts", "chunklengths", "regionsquaredchunkcounts",
        "regionchunkcounts")


@pytest.fixture(autouse=True)
def quiet():
    set_log_file(io.StringIO())


def mosaic(seed, M, N, founders=5, switch=0.04):
    """Each haplotype a walk over a few founders, with a little noise; the
    first haplotype alone carries a 1 at sites 0 and 1, the last at site
    N - 1, so that they have zero-length matches at the panel's ends."""
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((founders, N)) < 0.4).astype(np.uint8)
    src = rng.randint(founders, size=M)
    X = np.empty((M, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(M) < switch
        src[sw] = rng.randint(founders, size=int(sw.sum()))
        X[:, k] = F[src, k]
    X ^= (rng.random_sample((M, N)) < 0.005).astype(np.uint8)
    X[:, [0, 1, N - 1]] = 0
    X[0, :2] = X[-1, -1] = 1
    return X


def hand_segments(seed, M, N, empty=()):
    """Random segments a recipient in ascending end (none for those of
    `empty`), each of another end than the others of its recipient, so that
    the order within an end cannot matter."""
    rng = np.random.RandomState(seed)
    out = {}
    for h in range(M):
        n = 0 if h in empty else rng.randint(1, min(12, N - 1))
        e = np.sort(rng.choice(np.arange(2, N + 1), size=n, replace=False))
        s = np.array([rng.randint(0, x - 1) for x in e], np.int64)
        out[h] = np.stack([rng.randint(0, M, size=n), s, e], 1).astype(
            np.int64).reshape(-1, 3)
    return out


def columns(segs, M):
    """A recipient's rows as the port's segment columns."""
    rows = [segs[h] for h in range(M)]
    off = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    flat = np.concatenate(rows).reshape(-1, 3)
    sj, ss, se = (np.ascontiguousarray(flat[:, c], np.int32)
                  for c in range(3))
    return sj, ss, se, off.astype(np.int64)


def port_segments(X):
    p = PBWT.from_haplotypes(X)
    sj, ss, se, off = (np.array(c) for c in
                       port_paint._collect_match_arrays(p))
    return {h: np.stack([sj[off[h]:off[h + 1]], ss[off[h]:off[h + 1]],
                         se[off[h]:off[h + 1]]], 1).astype(np.int64)
            for h in range(X.shape[0])}


def normalised(tables, N, ploidy):
    """The port's accumulated tables with each recipient's chunk lengths
    scaled as -paint writes them."""
    out = [np.array(t, np.float64) for t in tables]
    total = out[1].sum(1, keepdims=True)
    out[1] = np.where(total != 0, out[1] / np.where(total, total, 1) * N
                      * ploidy, out[1])
    return out


def host_c(lib, cols, M, N, ploidy, cpr):
    sj, ss, se, off = cols
    n = M // ploidy
    counts, tl, c2, c3 = (np.zeros((n, n)) for _ in range(4))
    nreg = np.zeros(n)
    lib.paint_accumulate(sj, ss, se, off, M, N, n, ploidy, cpr, -1.0,
                         counts.reshape(-1), c2.reshape(-1), c3.reshape(-1),
                         tl.reshape(-1), nreg, np.zeros(n))
    return counts, tl, c2, c3, nreg


def twin(cols, M, N, ploidy, cpr):
    sj, ss, se, off = (torch.from_numpy(np.ascontiguousarray(a))
                       for a in cols)
    return [t.numpy() for t in port_device.paint_accumulate(
        off, sj, ss, se, M, N, ploidy, cpr)]


def assert_close(got, want):
    """Each table within 1e-12 of its largest absolute entry (f64 in
    another order), nregions equal."""
    for g, w in zip(got[:4], want[:4]):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max(initial=1e-300)
    assert np.array_equal(np.asarray(got[4]), np.asarray(want[4]))


PANELS = {   # name -> (seed, M, N)
    "even": (0, 40, 150),
    "odd_haplotypes": (1, 37, 120),
    "odd_individuals": (2, 66, 200),
    "two": (3, 2, 50),
}


@pytest.mark.parametrize("panel", sorted(PANELS))
def test_segments_are_the_ports(panel):
    """The reference's set-maximal matches of each haplotype against the
    panel without it are the port's within-panel segments, set for set, in
    the same order of ends: at the panel's first and last sites too, and
    with the zero-length matches the scan reports."""
    seed, M, N = PANELS[panel]
    X = mosaic(seed, M, N)
    want = port_segments(X)
    cols = torch.from_numpy(X).t().contiguous()
    zero = 0
    for h in range(M):
        got = reference.segments(cols, h)
        assert np.array_equal(got[:, 2], want[h][:, 2]), h
        assert sorted(map(tuple, got)) == sorted(map(tuple, want[h])), h
        assert got[-1, 2] == N
        zero += int((got[:, 1] == got[:, 2]).sum())
    assert zero >= M - 1


# name -> (segments of (seed, M, N) or hand segments, M, N, ploidy, cpr)
CASES = {
    "panel_cpr1": ("panel", 0, 40, 150, 2, 1),
    "panel_cpr3": ("panel", 2, 66, 200, 2, 3),
    "panel_cpr100": ("panel", 2, 66, 1000, 2, 100),
    "panel_ploidy1_odd": ("panel", 1, 37, 120, 1, 4),
    "panel_beyond_segments": ("panel", 4, 30, 90, 2, 10_000),
    "hand_empty": ("hand", 5, 30, 60, 2, 2),
    "hand_empty_ploidy1": ("hand", 6, 21, 45, 1, 3),
}


def case_segments(case):
    kind, seed, M, N, ploidy, cpr = CASES[case]
    if kind == "panel":
        return port_segments(mosaic(seed, M, N)), M, N, ploidy, cpr
    return hand_segments(seed, M, N, empty=(0, 7)), M, N, ploidy, cpr


@pytest.mark.parametrize("twin_elements", [None, 256, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_tables_are_the_ports(monkeypatch, case, twin_elements):
    """The reference's rows of every individual against the port's tables
    on the twin route (K6's plain twin on CPU tensors, also in batches of
    a few haplotypes) and on the host C route: within
    1e-12 of each table's largest entry, nregions equal. Recipients without
    segments, a chunksperregion of 1 (a region each advance), 3, 100 and
    past any recipient's segments, ploidy 1 and 2, an odd count of
    individuals."""
    if twin_elements:
        monkeypatch.setattr(port_device, "TWIN_ELEMENTS", twin_elements)
    segs, M, N, ploidy, cpr = case_segments(case)
    cols = columns(segs, M)
    want = reference.tables(segs, range(M // ploidy), M, N, ploidy, cpr)
    want = [t.numpy() for t in want]
    for got in (twin(cols, M, N, ploidy, cpr),
                host_c(native.get_lib(), cols, M, N, ploidy, cpr)):
        assert_close(normalised(got, N, ploidy)[:4] + [got[4]], want)
    assert want[0].any()
    assert want[4].any() != (cpr == 10_000)
    if CASES[case][0] == "panel":         # zero-length segments advance too
        assert any((segs[h][:, 1] == segs[h][:, 2]).any() for h in segs)


def test_reference_rows_of_a_sample():
    """Rows of a few individuals alone are those rows of the whole."""
    segs, M, N, ploidy, cpr = case_segments("panel_cpr3")
    whole = reference.tables(segs, range(M // ploidy), M, N, ploidy, cpr)
    some = [3, 17, 30]
    part = reference.tables({h: segs[h] for i in some
                             for h in (2 * i, 2 * i + 1)}, some, M, N,
                            ploidy, cpr)
    for w, p in zip(whole, part):
        assert torch.equal(w[some], p)


@pytest.mark.parametrize("case", ["panel_cpr3", "panel_ploidy1_odd"])
def test_reference_tables_are_the_jax_packages(case):
    """The reference's tables against the JAX package's -paint pass on its
    C runtime, over its own collection of the same panel: within 1e-12 of
    each table's largest entry, nregions equal."""
    _, seed, M, N, ploidy, cpr = CASES[case]
    X = mosaic(seed, M, N)
    p = jax_pbwt.PBWT.from_haplotypes(X)
    cols = tuple(np.asarray(c) for c in jax_paint._collect_match_arrays(p))
    got = host_c(jax_native.get_lib(), cols, M, N, ploidy, cpr)
    segs, *_ = case_segments(case)
    want = reference.tables(segs, range(M // ploidy), M, N, ploidy, cpr)
    assert_close(normalised(got, N, ploidy)[:4] + [got[4]],
                 [t.numpy() for t in want])


def rendered(tables):
    """The four files' text as pbwtPaint.c prints the tables."""
    counts, lengths, c2, c3, nreg = tables
    n = len(nreg)
    head = "".join(f" IND{i + 1}" for i in range(n))
    out = []
    for t, table in enumerate((counts, lengths, c2, c3)):
        lines = [("RECIPIENT nregions" if t >= 2 else "RECIPIENT") + head]
        for i in range(n):
            lead = f"IND{i + 1}" + (f" {nreg[i]:.2f}" if t >= 2 else "")
            lines.append(lead + "".join(f" {v:.4f}" for v in table[i]))
        out.append("\n".join(lines) + "\n")
    return out


@pytest.mark.parametrize("route", ["cpu", "0"])
def test_returned_tables_print_as_the_files(tmp_path, monkeypatch, route):
    """paint_ancestry_matrix returns the tables it wrote: float64, the
    chunk lengths normalised; printed as pbwtPaint.c prints them they are
    the four files, byte for byte."""
    monkeypatch.setenv("PBWT_TORCH_DEVICE", route)
    X = mosaic(7, 24, 90)
    p = PBWT.from_haplotypes(X)
    got = port_paint.paint_ancestry_matrix(p, str(tmp_path / "P"), 4, 2)
    assert len(got) == 5
    assert all(isinstance(t, np.ndarray) and t.dtype == np.float64
               for t in got)
    assert got[0].shape == (12, 12) and got[4].shape == (12,)
    np.testing.assert_allclose(got[1].sum(1), 90 * 2)
    files = [(tmp_path / f"P.{t}.out").read_text() for t in TAGS]
    assert files == rendered(got)


def test_one_paint_leaves_its_spans_and_counters(tmp_path, monkeypatch):
    """Under a profiler, one paint on the twin route leaves the root
    ops.paint and its six stages as children; the counters hold the
    recipients, the segments the collection gave, the intervals and cells
    of K6's preparation and the bytes of the four files."""
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    X = mosaic(8, 30, 100)
    p = PBWT.from_haplotypes(X)
    sj, ss, se, off = (np.array(c) for c in
                       port_paint._collect_match_arrays(p))
    prep = port_device.prepare(*(torch.from_numpy(a) for a in
                                 (off, sj, ss, se)), 30, 100, 2, 5)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        port_paint.paint_ancestry_matrix(p, str(tmp_path / "P"), 5, 2)
    roots = tracing.records("ops.paint")
    assert len(roots) == 1 and roots[0].parent is None
    children = [r for r in tracing.records() if r.parent == roots[0].id]
    stages = ("collect", "upload", "prepare", "k6", "download", "write")
    assert [r.name for r in children] == [f"ops.paint.{s}" for s in stages]
    assert all(r.root == roots[0].id for r in children)
    sizes = sum(os.path.getsize(tmp_path / f"P.{t}.out") for t in TAGS)
    assert tracing.counters() == {
        "ops.paint.recipients": 30, "ops.paint.segments": len(sj),
        "ops.paint.intervals": prep.hap_iv.shape[0],
        "ops.paint.cells": prep.cell_key.numel(),
        "ops.paint.bytes_written": sizes}
    assert prep.hap_iv.shape[0] > 0 and sizes > 0
    tracing.reset()
