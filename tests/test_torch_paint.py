"""The port's painting, within-panel matchers and -imputeMissing on the CPU
against the JAX package's: the plain twin of kernel K6 against the JAX
device pass (f32) and against the host C pass (f64, other order); the port's
C pass against the JAX package's, bit for bit; the commands end to end
against ``python -m pbwt_tpu`` on its host engine."""

import gzip
import io
import os
import subprocess
import sys
from collections import defaultdict
from fractions import Fraction

import numpy as np
import pytest
import torch

import pbwt_tpu.algos.impute as ref_impute
import pbwt_tpu.algos.match as ref_match
import pbwt_tpu.algos.paint as ref_paint
import pbwt_tpu.core.native as ref_native
import pbwt_tpu.core.pack3 as ref_pack3
import pbwt_tpu.core.pbwt as ref_pbwt
import pbwt_tpu.core.registry as ref_registry
import pbwt_tpu.io.pbwtfile as ref_pbwtfile
import pbwt_tpu.utils as ref_utils
from pbwt_tpu.ops.paint_jax import paint_totals_device
import pbwt_tpu_torch.algos.impute as port_impute
import pbwt_tpu_torch.algos.match as port_match
import pbwt_tpu_torch.algos.paint as port_paint
import pbwt_tpu_torch.core.native as port_native
import pbwt_tpu_torch.core.pbwt as port_pbwt
import pbwt_tpu_torch.core.registry as port_registry
import pbwt_tpu_torch.utils as port_utils
from pbwt_tpu_torch.ops import convert, kernels
from pbwt_tpu_torch.ops import paint as port_device

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("chunkcounts.out", "chunklengths.out",
          "regionsquaredchunkcounts.out", "regionchunkcounts.out")
SPARSE = ("nregions", "chunkcounts", "chunklengths",
          "regionsquaredchunkcounts", "regionchunkcounts")


@pytest.fixture(autouse=True)
def host_routes(monkeypatch):
    """Both packages on their host engines unless a test says otherwise,
    logs discarded, registries fresh."""
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "0")
    monkeypatch.setenv("PBWT_TPU_DEVICE", "0")
    for utils, registry in ((ref_utils, ref_registry),
                            (port_utils, port_registry)):
        registry.init()
        utils.set_log_file(io.StringIO())


def mosaic(seed, M, N, founders=5, switch=0.04):
    """tests/test_paint_device.py's panel: each haplotype a walk over a few
    founders."""
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


def segments_of(X):
    """The port's within-panel segments of X: (sj, ss, se, seg_off)."""
    p = port_pbwt.PBWT.from_haplotypes(X)
    return tuple(np.array(c) for c in port_paint._collect_match_arrays(p))


def hand_segments(seed, M, N, ploidy, empty=(), tail=()):
    """Random segments a recipient, in ascending end: none for those of
    `empty`; for those of `tail`, every segment ends before N - 5, so that
    the last sites take the tail case (every segment expired)."""
    rng = np.random.RandomState(seed)
    cols, off = [], [0]
    for i in range(M):
        n = 0 if i in empty else rng.randint(1, 12)
        top = N - 5 if i in tail else N
        s = rng.randint(0, top - 1, size=n)
        e = np.minimum(s + rng.randint(1, N // 2, size=n), top)
        j = rng.randint(0, M, size=n)
        order = np.argsort(e, kind="stable")
        cols.append(np.stack([j, s, e])[:, order])
        off.append(off[-1] + n)
    sj, ss, se = (np.ascontiguousarray(c, np.int32)
                  for c in np.concatenate(cols, axis=1))
    return sj, ss, se, np.asarray(off, np.int64)


def heavy_segments(seed, M, N):
    """A heavy cell: at ploidy 2, individual 1 covers both haplotypes of
    individual 0 at every site (a segment [0, N), whose window no other
    segment of theirs stops, as they all start at 0 or 1), so that cell
    takes about 2N additions; the other recipients as hand_segments."""
    rng = np.random.RandomState(seed)
    sj, ss, se, off = hand_segments(seed, M, N, 2, tail=(5,))
    cols = []
    for i in range(M):
        c = np.stack([sj, ss, se])[:, off[i]:off[i + 1]]
        if i < 2:
            n = rng.randint(3, 9)
            e = np.sort(rng.randint(2, N, size=n))
            c = np.concatenate([np.stack([rng.randint(0, M, size=n),
                                          rng.randint(0, 2, size=n), e]),
                                [[2 + i], [0], [N]]], axis=1)
        cols.append(c)
    out = (np.ascontiguousarray(c, np.int32)
           for c in np.concatenate(cols, axis=1))
    return (*out, np.concatenate([[0], np.cumsum([c.shape[1] for c in cols])]
                                 ).astype(np.int64))


def host_c(lib, segs, M, N, ploidy, cpr):
    """native paint_accumulate of lib: (counts, totlengths, counts2, counts3,
    nregions)."""
    sj, ss, se, off = segs
    n = M // ploidy
    counts, tl, c2, c3 = (np.zeros((n, n)) for _ in range(4))
    nreg = np.zeros(n)
    lib.paint_accumulate(sj, ss, se, off, M, N, n, ploidy, cpr, -1.0,
                         counts.reshape(-1), c2.reshape(-1), c3.reshape(-1),
                         tl.reshape(-1), nreg, np.zeros(n))
    return counts, tl, c2, c3, nreg


def twin(segs, M, N, ploidy, cpr):
    sj, ss, se, off = (torch.from_numpy(a) for a in segs)
    before = dict(kernels.LAUNCHES)
    got = port_device.paint_accumulate(off, sj, ss, se, M, N, ploidy, cpr)
    assert kernels.LAUNCHES == before    # CPU tensors never reach a kernel
    return tuple(t.numpy() for t in got)


CASES = {   # name -> (segments, M, N, ploidy, chunksperregion)
    "panel_cpr3": (lambda: segments_of(mosaic(0, 16, 80)), 16, 80, 2, 3),
    "panel_cpr1": (lambda: segments_of(mosaic(1, 40, 150)), 40, 150, 2, 1),
    "panel_cpr100": (lambda: segments_of(mosaic(2, 66, 200)), 66, 200, 2,
                     100),
    "panel_ploidy1": (lambda: segments_of(mosaic(3, 37, 120)), 37, 120, 1, 4),
    "tail_and_empty": (lambda: hand_segments(4, 30, 60, 2, empty=(3, 17),
                                             tail=(0, 5, 11, 20)),
                       30, 60, 2, 2),
    "tail_ploidy1": (lambda: hand_segments(5, 21, 45, 1, empty=(0,),
                                           tail=(1, 2, 9)), 21, 45, 1, 3),
    "heavy_cell": (lambda: heavy_segments(6, 12, 300), 12, 300, 2, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_matches_host_c(case):
    """K6's twin against the port's C pass: every table within 1e-9
    absolute and within 1e-12 of its largest entry (f64 in another order),
    nregions exactly; recipients with the tail case, without segments, a
    chunksperregion of 1, 3, 4, 100 (more than any recipient's segments)
    and 2, at ploidy 1 and 2."""
    make, M, N, ploidy, cpr = CASES[case]
    segs = make()
    want = host_c(port_native.get_lib(), segs, M, N, ploidy, cpr)
    got = twin(segs, M, N, ploidy, cpr)
    for g, w in zip(got[:4], want[:4]):
        assert g.shape == w.shape and np.isfinite(g).all()
        err = np.abs(g - w).max()
        assert err <= 1e-9 and err <= 1e-12 * np.abs(w).max()
    assert np.array_equal(got[4], want[4])
    assert want[0].any() and (want[2].any() or cpr == 100)
    if cpr == 100:
        assert np.array_equal(want[4], np.zeros_like(want[4]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_c_equals_jax_package(case):
    """The port's C pass gives the JAX package's C pass's tables to the bit
    (the region squares are one fused multiply-add in both); so does the
    sparse per-individual pass."""
    make, M, N, ploidy, cpr = CASES[case]
    segs = make()
    got = host_c(port_native.get_lib(), segs, M, N, ploidy, cpr)
    want = host_c(ref_native.get_lib(), segs, M, N, ploidy, cpr)
    assert all(np.array_equal(g.view(np.int64), w.view(np.int64))
               for g, w in zip(got, want))
    n = M // ploidy

    def sparse(lib):
        rows = []
        for i in range(n):
            t = [np.zeros(n) for _ in range(4)]
            t += [np.zeros(1), np.zeros(n), np.zeros(1)]
            lib.paint_sparse_ind(*segs, i * ploidy, (i + 1) * ploidy, N, n,
                                 ploidy, cpr, 3.0, *t)
            rows.append(np.concatenate(t))
        return np.array(rows).view(np.int64)
    assert np.array_equal(sparse(port_native.get_lib()),
                          sparse(ref_native.get_lib()))


def test_twin_matches_jax_device_pass():
    """K6's twin against paint_totals_device (plain jit on the CPU) at
    tests/test_paint_device.py's shape, chunk 32, on the JAX package's
    match segments, as (nseg, 4) rows converted to K6's columns: counts and
    lengths of each (recipient haplotype, donor individual) within rtol
    1e-5 (the JAX pass is f32). A haplotype alone is painted by giving the
    twin its rows only."""
    X = mosaic(0, 16, 80)
    M, N = X.shape
    rows = []
    ref_match.match_maximal_within(ref_pbwt.PBWT.from_haplotypes(X),
                                   lambda *r: rows.append(r))
    rows = np.asarray(rows, np.int64)     # by end site, not by recipient
    map_ih = np.arange(M) // 2
    c_j, l_j, _, _ = paint_totals_device(rows, M, N, map_ih, chunk=32)
    off, sj, ss, se = convert.paint_segments_from_jax(rows, M)
    assert np.array_equal(np.diff(off), np.bincount(rows[:, 0], minlength=M))
    for i in range(M):
        alone = np.zeros(M + 1, np.int64)
        alone[i + 1:] = off[i + 1] - off[i]
        got = twin((sj[off[i]:off[i + 1]], ss[off[i]:off[i + 1]],
                    se[off[i]:off[i + 1]], alone), M, N, 2, 5)
        np.testing.assert_allclose(got[0][i // 2], c_j[i], rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(got[1][i // 2], l_j[i], rtol=1e-5,
                                   atol=1e-8)
    assert c_j.any()


def test_covering_pairs_counts_the_window():
    """covering_pairs against a count by the reference's loop."""
    make, M, N, ploidy, cpr = CASES["tail_and_empty"]
    sj, ss, se, off = make()
    n = 0
    for i in range(M):
        lo, hi = off[i], off[i + 1]
        if lo == hi:
            continue
        m1 = lo
        for k in range(1, N):
            while se[m1] <= k and m1 < hi - 1:
                m1 += 1
            m = m1
            while m < hi and ss[m] < k:
                n += sj[m] // ploidy != i // ploidy
                m += 1
    t = (torch.from_numpy(a) for a in (off, sj, ss, se))
    assert port_device.covering_pairs(*t, N, ploidy) == n > 0


def host_loop(segs, M, N, ploidy, cpr):
    """The host's loop (native paint_accumulate) in Python: each (haplotype,
    site)'s normaliser, each cell's window pairs (haplotype, site, start,
    end) in the order the host adds them, and each haplotype's close
    sites."""
    sj, ss, se, off = (a.tolist() for a in segs)
    n = M // ploidy
    ssum = np.zeros((M, N), np.int64)
    pairs, closes = defaultdict(list), [[] for _ in range(M)]
    for i in range(M):
        lo, hi = off[i], off[i + 1]
        if lo == hi:
            continue
        me, m1, n1 = i // ploidy, lo, 1
        for k in range(1, N):
            while se[m1] <= k and m1 < hi - 1:
                if n1 % cpr == 0:
                    closes[i].append(k)
                m1, n1 = m1 + 1, n1 + 1
            m = m1
            while m < hi and ss[m] < k:
                if sj[m] // ploidy != me:
                    ssum[i, k] += (k - ss[m]) * (se[m] - k)
                    pairs[me * n + sj[m] // ploidy].append(
                        (i, k, ss[m], se[m]))
                m += 1
    return ssum, pairs, closes


def normalisers(prep, M, N):
    """Plain sums of K6's first phase: (M, N) int64, the weights
    (k - start)(end - k) of the intervals at each (haplotype, site), from
    difference arrays of their count, start + end and start * end."""
    a, b, s, e = prep.hap_iv.long().t()
    hap = torch.repeat_interleave(torch.arange(M), torch.diff(prep.hap_off))
    d = torch.zeros((3, M, N + 1), dtype=torch.long)
    for c, v in enumerate((torch.ones_like(s), s + e, s * e)):
        d[c].index_put_((hap, a), v, accumulate=True)
        d[c].index_put_((hap, b), -v, accumulate=True)
    c = d.cumsum(2)[:, :, :N]
    k = torch.arange(N)
    return (-c[0] * k * k + c[1] * k - c[2]).numpy()


def after(sites, lo, hi, k):
    """The first index in [lo, hi) whose close site is past k."""
    while lo < hi and sites[lo] <= k:
        lo += 1
    return lo


def cell_walk(prep, c):
    """K6's walk of cell c in its order (csrc/paint.cu, k6_cells): ("add",
    haplotype, site, start, end) for every weighed pair and ("close",
    haplotype) where the open region is flushed (a close between two of its
    additions, or after its last in a haplotype)."""
    a, b, st, en = prep.cell_iv.t().tolist()
    hap, off = prep.cell_hap.tolist(), prep.cell_off.tolist()
    cl, close_off = prep.close_site.tolist(), prep.close_off.tolist()
    i, end = off[c], off[c + 1]
    while i < end:
        h, j = hap[i], i
        while j < end and hap[j] == h:
            j += 1
        cend = close_off[h + 1]
        k, p, q = a[i], i, i
        cp = after(cl, close_off[h], cend, k)
        while True:
            while q < j and a[q] <= k:
                q += 1
            for r in range(p, q):
                yield "add", h, k, st[r], en[r]
            nk = k + 1
            while p < j and b[p] <= nk:
                p += 1
            if p == j:
                break
            q = max(q, p)
            if q == p:
                nk = max(nk, a[p])
            if cp < cend and cl[cp] <= nk:
                yield "close", h
                cp = after(cl, cp, cend, nk)
            k = nk
        if cp < cend:
            yield "close", h
        i = j


def fma(x, y, z):
    """x * y + z rounded once (Python 3.12 has no math.fma)."""
    return float(Fraction(x) * Fraction(y) + Fraction(z))


@pytest.mark.parametrize("case", sorted(CASES))
def test_k6_preparation_matches_host_loop(case):
    """K6's preparation on CPU tensors against the host's loop: the
    normalisers exactly, each cell's pairs in the host's order, each
    haplotype's close sites and the region counts; the pairs are the twin's
    count."""
    make, M, N, ploidy, cpr = CASES[case]
    segs = make()
    cols = [torch.from_numpy(a) for a in (segs[3], *segs[:3])]
    prep = port_device.prepare(*cols, M, N, ploidy, cpr)
    ssum, pairs, closes = host_loop(segs, M, N, ploidy, cpr)
    assert np.array_equal(normalisers(prep, M, N)[:, 1:], ssum[:, 1:])
    keys = prep.cell_key.tolist()
    assert keys == sorted(pairs) and sorted(prep.sched.tolist()) == list(
        range(len(keys)))
    for c, key in enumerate(keys):
        walk = [ev[1:] for ev in cell_walk(prep, c) if ev[0] == "add"]
        assert walk == pairs[key]
    off = prep.close_off.tolist()
    assert [prep.close_site[off[i]:off[i + 1]].tolist()
            for i in range(M)] == closes
    want = np.array([sum(len(closes[i * ploidy + h]) for h in range(ploidy))
                     for i in range(M // ploidy)], np.float64)
    assert np.array_equal(prep.nregions.numpy(), want)
    assert sum(map(len, pairs.values())) == port_device.covering_pairs(
        *cols, N, ploidy)
    if case == "heavy_cell":
        assert max(map(len, pairs.values())) >= 2 * (N - 2)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k6_cell_order_equals_host_c_bits(case):
    """The cells walked in K6's order with Python floats (IEEE f64, each
    operation rounded once; the region squares one fused multiply-add) over
    the preparation and the exact normalisers: the five tables equal the
    port's C pass bit for bit."""
    make, M, N, ploidy, cpr = CASES[case]
    segs = make()
    cols = [torch.from_numpy(a) for a in (segs[3], *segs[:3])]
    prep = port_device.prepare(*cols, M, N, ploidy, cpr)
    z = normalisers(prep, M, N).astype(np.float64)
    n = M // ploidy
    got = np.zeros((4, n * n))
    for c in prep.sched.tolist():
        tl = cnt = c2 = c3 = part = 0.0
        at = -1
        for ev in cell_walk(prep, c):
            if ev[1] != at:             # a haplotype opens with no region
                at, part = ev[1], 0.0
            if ev[0] == "close":        # a flush of a zero part changes nothing
                c2, c3, part = fma(part, part, c2), c3 + part, 0.0
                continue
            _, h, k, s, e = ev
            if z[h, k] == 0.0:          # the host skips a site whose sum is 0
                continue
            w = float((k - s) * (e - k)) / z[h, k]
            tc = w / float(e - s)
            tl, cnt, part = tl + w, cnt + tc, part + tc
        got[:, prep.cell_key[c]] = cnt, tl, c2, c3
    want = host_c(port_native.get_lib(), segs, M, N, ploidy, cpr)
    for g, w in zip((*got.reshape(4, n, n), prep.nregions.numpy()), want):
        assert np.array_equal(g.view(np.int64), w.view(np.int64))
    assert want[0].any()


def test_k6_arguments_match_the_entry_signature(monkeypatch):
    """The arguments the wrapper hands the C entry are as many as its ctypes
    signature types (a surplus one would go as a 32-bit int)."""
    make, M, N, ploidy, cpr = CASES["panel_cpr3"]
    sj, ss, se, off = make()
    prep = port_device.prepare(*(torch.from_numpy(a) for a in
                                 (off, sj, ss, se)), M, N, ploidy, cpr)
    monkeypatch.setattr(kernels, "stream", lambda dev: 0)
    dev = type("Dev", (), {"index": 0})()
    args = port_device.k6_arguments(dev, M, N, prep, torch.zeros(1),
                                    [torch.zeros(1)] * 4)
    assert len(args) == len(kernels._SIGNATURES["k6_paint_accumulate"]) == 20


def test_paint_device_route_needs_whole_individuals():
    p = port_pbwt.PBWT.from_haplotypes(mosaic(6, 9, 30))
    with pytest.raises(ValueError, match="ploidy 2"):
        port_paint.paint_ancestry_matrix(p, "unused", 10, 2)


# ------------------------------------------------------------ in-process

def both_panels(X, sites=True):
    out = []
    for mod in (port_pbwt, ref_pbwt):
        s = [mod.Site(x=100 + i) for i in range(X.shape[1])] if sites \
            else None
        out.append(mod.PBWT.from_haplotypes(X, sites=s))
    return out


def read_tables(root):
    return [open(f"{root}.{t}").read() for t in TABLES]


@pytest.mark.parametrize("route", ["0", "cpu", "ref_numpy"])
def test_paint_matches_jax_package(tmp_path, monkeypatch, route):
    """paint_ancestry_matrix on the port's host C route and on the device
    route (K6's twin on CPU tensors, through one wrapper call) against the
    JAX package's on its C runtime, and on the host C route against the
    JAX package's loop without its runtime (ref_numpy): the four files byte
    for byte."""
    X = mosaic(9, 24, 90)
    if route == "ref_numpy":
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    pp, pr = both_panels(X)
    calls = []
    real = port_device.paint_accumulate
    monkeypatch.setattr(port_device, "paint_accumulate",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("PBWT_TORCH_DEVICE",
                       "0" if route == "ref_numpy" else route)
    port_paint.paint_ancestry_matrix(pp, str(tmp_path / "port"), 4, 2)
    ref_paint.paint_ancestry_matrix(pr, str(tmp_path / "ref"), 4, 2)
    assert len(calls) == (route == "cpu")
    got, want = read_tables(tmp_path / "port"), read_tables(tmp_path / "ref")
    assert got == want and "nregions" in got[2]


@pytest.mark.parametrize("route", ["0", "ref_numpy"])
def test_paint_sparse_and_local_match_jax_package(tmp_path, monkeypatch,
                                                  route):
    """-paintSparse (the per-individual C pass) against the JAX package's
    streams, on its C runtime or on its loop without it (ref_numpy), byte
    for byte (zlib's gzip wrapper and deflate stream); and -paint's
    outputlocal, which always takes the reference's loop."""
    X = mosaic(10, 20, 70)
    if route == "ref_numpy":
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    pp, pr = both_panels(X)
    for paint, side, p in ((port_paint, "port", pp), (ref_paint, "ref", pr)):
        paint.paint_ancestry_matrix_sparse(p, str(tmp_path / side), 3, 2, 4)
        paint.paint_ancestry_matrix(p, str(tmp_path / f"{side}L"), 3, 2, 1)
    for t in SPARSE:
        got = (tmp_path / f"port.{t}.s.out.gz").read_bytes()
        want = (tmp_path / f"ref.{t}.s.out.gz").read_bytes()
        if route == "ref_numpy":
            # the JAX package's loop writes through Python's gzip module,
            # whose wrapper and deflate blocks differ from zlib's gzopen:
            # the streams' text (the C route's bytes are the case "0")
            assert gzip.decompress(got) == gzip.decompress(want)
        else:
            assert got == want
        assert gzip.decompress(got)
    for t in ("localancestry.out", *TABLES):
        got = (tmp_path / f"portL.{t}").read_bytes()
        assert got == (tmp_path / f"refL.{t}").read_bytes()


def test_paint_sparse_bytes_repeat(tmp_path):
    """-paintSparse's streams are the same bytes from run to run and under
    another root: zlib's gzip header with flags 0 (no file name), mtime 0
    and OS 3, as gzopen writes it."""
    X = mosaic(11, 16, 60)
    pp, _ = both_panels(X)
    for root in ("one", "two"):
        port_paint.paint_ancestry_matrix_sparse(pp, str(tmp_path / root), 3,
                                                2, 0)
    for t in SPARSE:
        got = (tmp_path / f"one.{t}.s.out.gz").read_bytes()
        assert got == (tmp_path / f"two.{t}.s.out.gz").read_bytes()
        assert got[:10] == b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\x03"


@pytest.mark.parametrize("ref_numpy",
                         [False, pytest.param(True, id="ref_numpy")])
@pytest.mark.parametrize("seed,M,N", [(11, 30, 60), (12, 2, 25),
                                      (13, 70, 40)])
def test_within_matchers_match_jax_package(monkeypatch, ref_numpy, seed, M,
                                           N):
    """match_maximal_within and match_long_within (the C scans) report the
    JAX package's rows in its order, on its C runtime or on its numpy
    routes without it (ref_numpy), and max_within_length_hist gives its
    histogram."""
    if ref_numpy:
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    pp, pr = both_panels(mosaic(seed, M, N), sites=False)
    for fn in ("match_maximal_within", "match_long_within"):
        got, want = [], []
        args = () if fn == "match_maximal_within" else (8,)
        getattr(port_match, fn)(pp, *args, lambda *r: got.append(r))
        getattr(ref_match, fn)(pr, *args, lambda *r: want.append(r))
        assert got == want and (got or fn == "match_long_within")
    assert (port_match.max_within_length_hist(pp)
            == ref_match.max_within_length_hist(pr))


def missing_panel(pbwt_mod, pack3_mod, registry):
    """tests/test_algos.py's -imputeMissing panel: sites 10 and 30 missing
    for haplotypes 0-3, and site 44 for haplotypes 5 and 6."""
    rng = np.random.RandomState(8)
    F = (rng.random_sample((3, 50)) < 0.4).astype(np.uint8)
    X = np.empty((20, 50), np.uint8)
    for i in range(20):
        f = rng.randint(3)
        for k in range(50):
            if rng.random_sample() < 0.02:
                f = rng.randint(3)
            X[i, k] = F[f, k]
    sites = [pbwt_mod.Site(x=100 + i, varD=registry.variation("A", "T"))
             for i in range(50)]
    p = pbwt_mod.PBWT.from_haplotypes(X, chrom="1", sites=sites)
    chunks, offsets, off = [b"\x00"], np.zeros(p.N, np.int64), 1
    for k, rows in ((10, [0, 1, 2, 3]), (30, [0, 1, 2, 3]), (44, [5, 6])):
        miss = np.zeros(p.M, np.uint8)
        miss[rows] = 1
        offsets[k] = off
        chunks.append(pack3_mod.pack3(miss))
        off += len(chunks[-1])
    p.zMissing, p.missingOffset = b"".join(chunks), offsets
    return p


def impute_fields(p):
    return (p.M, p.N, p.yz, p.zDosage, np.asarray(p.dosageOffset).tolist(),
            np.asarray(p.aFend).tolist(),
            [(s.x, s.refFreq, s.imputeInfo) for s in p.sites])


@pytest.mark.parametrize("route", ["0", "cpu", "ref_numpy"])
def test_impute_missing_matches_jax_package(monkeypatch, route):
    """impute_missing on the host C pass (also when the device is named:
    the branch has no kernel): the JAX package's yz, dosages, aFend and
    each site's refFreq and imputeInfo, on its C runtime or on its numpy
    routes without it (ref_numpy: numpy votes, complete entries copied
    through)."""
    from pbwt_tpu_torch.core import pack3 as port_pack3
    if route == "ref_numpy":
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    want = ref_impute.impute_missing(
        missing_panel(ref_pbwt, ref_pack3, ref_registry))
    p = missing_panel(port_pbwt, port_pack3, port_registry)
    monkeypatch.setenv("PBWT_TORCH_DEVICE",
                       "0" if route == "ref_numpy" else route)
    got = port_impute.impute_missing(p)
    assert impute_fields(got) == impute_fields(want)
    X = got.haplotypes()
    assert np.array_equal(X[7:], p.haplotypes()[7:])


# ------------------------------------------------------------------- CLI

RUN_PORT = """
import runpy, sys
sys.argv = ["pbwt_tpu_torch"] + sys.argv[1:]
try:
    runpy.run_module("pbwt_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code
sys.stdout.flush()
alien = sorted(m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pbwt_tpu"))
if alien:
    sys.exit("imported: " + " ".join(alien))
sys.exit(rc)
"""


def run_both(args, cwd, port_env):
    """args through the port's CLI (with port_env) in cwd/port and through
    the JAX package's on its host engine in cwd/ref; their stdouts."""
    out = []
    for side, argv0, extra in (
            ("port", [sys.executable, "-c", RUN_PORT],
             dict(port_env, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")),
            ("ref", [sys.executable, "-m", "pbwt_tpu"],
             {"PBWT_TPU_DEVICE": "0"})):
        env = {k: v for k, v in os.environ.items()
               if k != "PBWT_TORCH_DEVICE"}
        env.update(extra)
        env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
        os.makedirs(cwd / side, exist_ok=True)
        res = subprocess.run([*argv0, *args], capture_output=True, env=env,
                             cwd=cwd / side, timeout=300)
        assert res.returncode == 0, res.stderr.decode()
        out.append(res.stdout)
    return out


@pytest.fixture(scope="module")
def paint_panel(tmp_path_factory):
    """tests/test_algos.py:227's panel (12 haplotypes x 60 sites) as a
    -writeAll root."""
    d = tmp_path_factory.mktemp("paint")
    rng = np.random.RandomState(9)
    F = (rng.random_sample((4, 60)) < 0.4).astype(np.uint8)
    X = np.empty((12, 60), np.uint8)
    for i in range(12):
        f = rng.randint(4)
        for k in range(60):
            if rng.random_sample() < 0.05:
                f = rng.randint(4)
            X[i, k] = F[f, k]
    p = ref_pbwt.PBWT.from_haplotypes(
        X, sites=[ref_pbwt.Site(x=i) for i in range(60)])
    ref_pbwtfile.write_all(p, str(d / "P"))
    return str(d / "P")


def numbers(text):
    return np.array([float(v) for ln in text.splitlines()[1:]
                     for v in ln.split()[1:]])


@pytest.mark.parametrize("device", ["0", "cpu"])
def test_cli_paint_equals_jax_package(tmp_path, paint_panel, device):
    """-paint: the four files byte-identical on the host route, the tables
    within 1e-9 on the twin's; -paint with outputlocal (the third option)
    writes the JAX package's localancestry.out too."""
    args = ["-readAll", paint_panel, "-paint", "A", "5", "2", "-paint", "B",
            "100", "2", "1"]
    run_both(args, tmp_path, {"PBWT_TORCH_DEVICE": device})
    for t in TABLES:
        got = (tmp_path / "port" / f"A.{t}").read_text()
        want = (tmp_path / "ref" / f"A.{t}").read_text()
        if device == "0":
            assert got == want
        else:
            assert got.splitlines()[0] == want.splitlines()[0]
            np.testing.assert_allclose(numbers(got), numbers(want), rtol=0,
                                       atol=1e-9)
    for t in ("localancestry.out", *TABLES):
        assert ((tmp_path / "port" / f"B.{t}").read_bytes()
                == (tmp_path / "ref" / f"B.{t}").read_bytes())


def test_cli_paint_sparse_and_within_equal_jax_package(tmp_path,
                                                       paint_panel):
    """-paintSparse's five streams byte for byte, and the stdout of
    -maxWithin, -longWithin 20, -stats -maxWithin and -check -maxWithin."""
    outs = [run_both(["-readAll", paint_panel, "-paintSparse", "S", "3", "2",
                      "2"], tmp_path, {})]
    for t in SPARSE:
        got = (tmp_path / "port" / f"S.{t}.s.out.gz").read_bytes()
        assert got == (tmp_path / "ref" / f"S.{t}.s.out.gz").read_bytes()
    for extra in (["-maxWithin"], ["-longWithin", "20"],
                  ["-stats", "-maxWithin"], ["-check", "-maxWithin"]):
        outs.append(run_both(["-readAll", paint_panel, *extra], tmp_path,
                             {}))
    for port, ref in outs[1:]:
        assert port == ref and port.count(b"\n") > 5


def test_cli_impute_missing_equals_jax_package(tmp_path):
    """-readAll root -imputeMissing -haps - on tests/test_algos.py:198's
    missing-data panel, written with its .missing sidecar."""
    p = missing_panel(ref_pbwt, ref_pack3, ref_registry)
    ref_pbwtfile.write_all(p, str(tmp_path / "M"))
    port, ref = run_both(["-readAll", str(tmp_path / "M"), "-imputeMissing",
                          "-haps", "-", "-writeAll", "O"], tmp_path, {})
    assert port == ref and port.count(b"\n") == 50
    for ext in ("pbwt", "sites", "dosage"):
        assert ((tmp_path / "port" / f"O.{ext}").read_bytes()
                == (tmp_path / "ref" / f"O.{ext}").read_bytes())
