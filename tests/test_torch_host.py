"""The port's own host layers against the JAX package's, on the same numpy
inputs made from a seed: every copied module gives the bytes its original
gives. The port's modules run with PBWT_TORCH_DEVICE=0 (host) unless a test
names the CPU device route; the JAX package's with PBWT_TPU_DEVICE=0."""

import gzip
import io
import os
import re

import numpy as np
import pytest
import torch

import pbwt_tpu.algos.likelihood as ref_likelihood
import pbwt_tpu.algos.match as ref_match
import pbwt_tpu.core.engine as ref_engine
import pbwt_tpu.core.native as ref_native
import pbwt_tpu.core.pack3 as ref_pack3
import pbwt_tpu.core.pbwt as ref_pbwt
import pbwt_tpu.core.registry as ref_registry
import pbwt_tpu.io.bgzf as ref_bgzf
import pbwt_tpu.io.pbwtfile as ref_pbwtfile
import pbwt_tpu.io.textformats as ref_textformats
import pbwt_tpu.io.vcf as ref_vcf
import pbwt_tpu.utils as ref_utils
import pbwt_tpu_torch.algos.likelihood as port_likelihood
import pbwt_tpu_torch.algos.match as port_match
import pbwt_tpu_torch.core.engine as port_engine
import pbwt_tpu_torch.core.native as port_native
import pbwt_tpu_torch.core.pack3 as port_pack3
import pbwt_tpu_torch.core.pbwt as port_pbwt
import pbwt_tpu_torch.core.registry as port_registry
import pbwt_tpu_torch.io.bgzf as port_bgzf
import pbwt_tpu_torch.io.pbwtfile as port_pbwtfile
import pbwt_tpu_torch.io.textformats as port_textformats
import pbwt_tpu_torch.io.vcf as port_vcf
import pbwt_tpu_torch.utils as port_utils
from pbwt_tpu_torch import ops
from pbwt_tpu_torch.ops import build as port_build

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def host_routes(monkeypatch):
    """Both packages on their host engines, logs discarded, registries
    fresh."""
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "0")
    monkeypatch.setenv("PBWT_TPU_DEVICE", "0")
    for utils, registry in ((ref_utils, ref_registry),
                            (port_utils, port_registry)):
        registry.init()
        utils.set_log_file(io.StringIO())


def _panel(seed, M, N, founders=6, switch=0.05):
    """Mosaics of a few founders: long runs in the sorted columns."""
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((founders, N)) < 0.4).astype(np.uint8)
    src = rng.randint(founders, size=M)
    X = np.empty((M, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(M) < switch
        src[sw] = rng.randint(founders, size=int(sw.sum()))
        X[:, k] = F[src, k]
    return X


def _sorted_columns(X):
    """(N, M) columns of X each in its site's PBWT order."""
    a = np.arange(X.shape[0], dtype=np.int32)
    Y = np.empty(X.T.shape, np.uint8)
    for k in range(X.shape[1]):
        Y[k] = X[a, k]
        a = ref_engine.forwards_a(a, Y[k])
    return Y


def _same(a, b):
    """Equality of what the host modules return: bytes, arrays, None and
    tuples of them."""
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


# ------------------------------------------------------------------ pack3

@pytest.mark.parametrize("seed,M,N", [(0, 1, 3), (1, 70, 9), (2, 4100, 5),
                                      (3, 333, 40)])
def test_pack3_pack_and_unpack(seed, M, N):
    """The port's one-column encoder, and its C runtime's panel codec
    (encode_cols, decode_cols), against the JAX package's numpy codec."""
    Y = _sorted_columns(_panel(seed, M, N))
    Y[0] = 0                                  # one run of M: the long codes
    for y in Y:
        assert port_pack3.pack3(y) == ref_pack3.pack3(y)
    got, want = port_native.encode_cols(Y), ref_pack3.pack_columns(Y)
    assert _same(got, want)
    yz = want[0]
    assert np.array_equal(port_native.decode_cols(yz, N, M),
                          ref_pack3.unpack_all(yz, M, N)[0])
    assert np.array_equal(port_native.decode_cols(yz, N, M), Y)


# ----------------------------------------------------------------- engine

@pytest.mark.parametrize("seed,M,N", [(4, 2, 1), (5, 257, 33), (6, 1500, 64)])
def test_engine_build_from_haplotypes_host(seed, M, N):
    X = _panel(seed, M, N)
    assert _same(port_engine.build_from_haplotypes(X),
                 ref_engine.build_from_haplotypes(X))
    a0 = np.random.RandomState(seed).permutation(M).astype(np.int32)
    assert _same(port_engine.build_from_haplotypes(X, a0),
                 ref_engine.build_from_haplotypes(X, a0))


def test_engine_cursor_updates():
    X = _panel(7, 90, 12)
    a_p = a_r = np.arange(90, dtype=np.int32)
    d_p = d_r = np.zeros(91, np.int32)
    for k in range(12):
        y = X[a_r, k]
        assert _same(port_engine.calculate_u(y), ref_engine.calculate_u(y))
        a_p, d_p = port_engine.forwards_ad(a_p, d_p, y, k)
        a_r, d_r = ref_engine.forwards_ad(a_r, d_r, y, k)
        assert _same((a_p, d_p), (a_r, d_r))
    up, ur = port_engine.WriteCursor(90), ref_engine.WriteCursor(90)
    for k in range(12):
        up.write_natural(X[:, k])
        ur.write_natural(X[:, k])
    assert up.packed() == ur.packed() and _same(up.a, ur.a)


# ----------------------------------------------------------------- native

def _native_case(name, native):
    X = _panel(8, 300, 50)
    Y = _sorted_columns(X)
    a0 = np.arange(300, dtype=np.int32)
    if name == "encode_cols":
        return native.encode_cols(Y)
    if name == "transpose_u8":
        return native.transpose_u8(X).copy()
    if name == "build_pbwt":
        return native.build_pbwt(np.ascontiguousarray(X.T), a0)
    yz = ref_native.encode_cols(Y)[0]
    if name == "natural_cols":
        first = native.natural_cols(yz, 16, 300, a0, with_pos=True)
        rest = native.natural_cols(yz, 34, 300, first[1], start=first[3],
                                   with_pos=True)
        assert np.array_equal(np.concatenate([first[0], rest[0]]), X.T)
        return tuple(v if isinstance(v, np.ndarray) else np.int64(v)
                     for v in (*first, *rest))
    if name == "decode_cols":
        return native.decode_cols(yz, 50, 300)
    if name == "col_counts":
        return native.col_counts(yz, 300, 50)
    if name == "build_pbwt_chunk":
        a = a0.copy()
        return native.build_pbwt_chunk(np.ascontiguousarray(X.T[:20]), a), a
    if name == "pack_advance":
        a = a0.copy()
        return native.pack_advance(Y[0], a), a
    if name == "select_repack":
        keep = (np.arange(50) % 3 != 1).astype(np.uint8)
        return native.select_repack(yz, 300, 50, keep, a0)
    if name == "subsample_repack":
        select = np.random.RandomState(12).permutation(300)[:120]
        return native.subsample_repack(yz, 300, 50, select.astype(np.int64),
                                       a0)
    if name == "build_reverse_core":
        a_end = native.build_pbwt(np.ascontiguousarray(X.T), a0)[1]
        return native.build_reverse_core(yz, 300, 50, a_end)
    if name in ("sweep_match", "sweep_match_packed"):
        Xq = _panel(13, 20, 50)
        Yq = _sorted_columns(Xq)
        aq0 = np.arange(20, dtype=np.int32)
        if name == "sweep_match":
            return native.sweep_match(Y, a0, Yq, aq0).copy()
        yzq = ref_native.encode_cols(Yq)[0]
        return native.sweep_match_packed(yz, 300, yzq, 20, 50, a0, aq0).copy()
    if name in ("segs_sort", "impute_vote_emit", "impute_emit"):
        return _impute_case(name, native, X, yz, a0)
    if name in PHASING_ENTRIES:
        return _phasing_case(name, native, X, yz, a0)
    if name in ("max_within", "long_within"):
        return (native.max_within(Y, a0) if name == "max_within"
                else native.long_within(Y, 6, a0)).copy()
    if name in ("max_within_packed", "long_within_packed"):
        return (native.max_within_packed(yz, 300, 50, a0)
                if name == "max_within_packed"
                else native.long_within_packed(yz, 6, 300, 50, a0)).copy()
    if name in ("max_within_bucketed", "buckets_sort_start"):
        cols = tuple(c.copy() for c in native.max_within_bucketed(
            yz, 300, 50, a0))
        if name == "buckets_sort_start":
            native.buckets_sort_start(*cols)
        return cols
    if name == "format_f4_rows":
        v = np.random.RandomState(10).random_sample((7, 30)) * 10 ** (
            np.arange(30) % 8)
        v[0, :4] = (0.0, 0.00005, 1.23455, 2.5e15)    # ties, the slow path
        v[1, :2] = (-0.5, -1e-9)
        return tuple(native.format_f4_rows(v)) + (native.format_f4_row(v[0]),)
    assert name == "write_match_rows"
    rows = np.random.RandomState(9).randint(0, 10**6, size=(500, 4))
    rows[::7, 3] = rows[::7, 2]               # empty matches are not printed
    out = io.BytesIO()
    native.write_match_rows(rows.astype(np.int64), out)
    return out.getvalue()


def _impute_case(name, native, X, yz, a0):
    """The imputation entries on 40 targets' segments against the 300
    donors over a 25-site frame (every second site): unsorted rows with
    equal starts for the sort; the streaming vote and the output stage on
    the sorted ones, a target without segments among them."""
    rng = np.random.RandomState(21)
    T, n = 40, 700
    start = rng.randint(0, 20, size=n)
    rows = np.stack([rng.randint(0, T, size=n), rng.randint(0, 300, size=n),
                     start, start + rng.randint(1, 8, size=n)], 1)
    rows = rows[rows[:, 0] != 17].astype(np.int64)
    if name == "segs_sort":
        return native.segs_sort(rows, T)
    kold = ((np.arange(50) + 1) // 2).astype(np.int64)
    if name == "impute_vote_emit":
        jr, s_, e_, off = ref_native.segs_sort(rows, T)
        return native.impute_vote_emit(yz, 300, 50, a0, None, off, T, kold,
                                       seg_cols=(jr, s_, e_))
    dos = rng.randint(0, 21, size=(50, T)) / 20.0
    dos[:, :9] = 0.0                         # long runs of one level
    return native.impute_emit((dos > 0.5).astype(np.uint8), dos,
                              rng.permutation(T).astype(np.int32))


PHASING_ENTRIES = ("crand_next", "corrupt_sites_core", "corrupt_samples_core",
                   "copy_samples_core", "gtcompare_core",
                   "phase_compare_core", "merge_core", "phase_resolve",
                   "phase_stop_max", "phase_sweep_core", "ref_phase4_core")


def _phasing_case(name, native, X, yz, a0):
    """The entries of the corruption, comparison, merge and phasing
    commands on the 300 x 50 panel: the rand() stream seeded first, a
    second panel of the same shape with 3% of its alleles changed, three
    batches to merge (one with columns to discard), the neighbour tables
    and stop maxima of one site, and both phasing sweeps."""
    lib = native.get_lib()
    lib.crand_srand(3)
    rng = np.random.RandomState(23)
    RAND_MAX = 2147483647
    if name == "crand_next":
        return [lib.crand_next() for _ in range(100)]
    if name == "corrupt_sites_core":
        return native.corrupt_sites_core(yz, 300, 50, a0, RAND_MAX // 3,
                                         RAND_MAX // 10, RAND_MAX / 300)
    if name == "corrupt_samples_core":
        return native.corrupt_samples_core(yz, 300, 50, a0, RAND_MAX // 4,
                                           RAND_MAX // 8, RAND_MAX / 300)
    if name == "copy_samples_core":
        return native.copy_samples_core(yz, 300, 50, a0, 120, RAND_MAX // 9)
    Xq = X ^ (rng.random_sample(X.shape) < 0.03).astype(np.uint8)
    yzq = ref_native.encode_cols(_sorted_columns(Xq))[0]
    if name == "gtcompare_core":
        rf = np.where(np.arange(50) % 3 == 0, 0.0, rng.random_sample(50))
        ii = np.where(np.arange(50) % 4 == 0, 1.0, rng.random_sample(50))
        fbound = np.array([0.1, 0.5, 1, 5, 10, 20, 50, 90, 100.01])
        return native.gtcompare_core(yz, yzq, 300, 50, a0, a0, rf, ii,
                                     fbound)
    if name == "phase_compare_core":
        return native.phase_compare_core(yz, yzq, 300, 50, a0, a0)
    if name == "merge_core":
        X2 = _panel(25, 64, 56)
        keep = np.ones(56, np.uint8)
        keep[[0, 9, 10, 31, 40, 55]] = 0
        parts = [(X[:100], np.ones(50, np.uint8)), (X2, keep),
                 (X[100:178], np.ones(50, np.uint8))]
        yzs = [ref_native.encode_cols(_sorted_columns(x))[0]
               for x, _ in parts]
        return native.merge_core(yzs, [len(x) for x, _ in parts],
                                 [np.arange(len(x), dtype=np.int32)
                                  for x, _ in parts],
                                 [k for _, k in parts], 50)
    a_end = ref_native.build_pbwt(np.ascontiguousarray(X.T), a0)[1]
    if name in ("phase_resolve", "phase_stop_max"):
        d = rng.randint(0, 40, size=301).astype(np.int32)
        y = (rng.random_sample(300) < 0.4).astype(np.uint8)
        if name == "phase_stop_max":
            bp, bm = np.empty(301, np.int64), np.empty(301, np.int64)
            lib.phase_stop_max(d, y, 1, 300, bp, bm)
            return bp, bm
        xp = np.where(X[:, 7] == 1, 1.0, -1.0)
        het = np.flatnonzero(X[0::2, 7] != X[1::2, 7]) * 2
        xp[het] = xp[het + 1] = 0.0
        aL = rng.randint(-1, 300, size=3 * 300).astype(np.int32)
        aR = rng.randint(-1, 300, size=3 * 300).astype(np.int32)
        wL = rng.random_sample(2 * 300) * 3
        wR = rng.random_sample(2 * 300) * 3
        lib.phase_resolve(xp, 300, 3, 2, aL, aR, wL, wR, 6.5)
        return xp
    score_bit = np.log(np.arange(1, 53, dtype=np.float64))
    if name == "phase_sweep_core":
        fwd = native.phase_sweep_core(yz, 300, 50, a0, True, None, None,
                                      None, None, 2, score_bit, 6.5)
        fwd = (fwd[0], fwd[1].copy(), fwd[2].copy())
        bwd = native.phase_sweep_core(yz, 300, 50, a_end, False, fwd[0],
                                      fwd[1], fwd[2], fwd[1], 2, score_bit,
                                      8.5)
        return fwd + bwd
    Xold = _panel(26, 40, 50)
    yzold = ref_native.encode_cols(_sorted_columns(Xold))[0]
    return native.ref_phase4_core(yzold, 40, yz, 300, 50,
                                  np.arange(40, dtype=np.int32), a0)


@pytest.mark.parametrize("name", [*PHASING_ENTRIES, "segs_sort",
                                  "impute_vote_emit", "impute_emit",
                                  "encode_cols", "natural_cols",
                                  "transpose_u8", "build_pbwt",
                                  "write_match_rows", "decode_cols",
                                  "col_counts", "build_pbwt_chunk",
                                  "pack_advance", "select_repack",
                                  "subsample_repack", "build_reverse_core",
                                  "sweep_match", "sweep_match_packed",
                                  "max_within", "long_within",
                                  "max_within_packed", "long_within_packed",
                                  "max_within_bucketed",
                                  "buckets_sort_start", "format_f4_rows"])
def test_native_entries(name):
    assert port_native.get_lib() is not None, "the C runtime did not build"
    got, want = _native_case(name, port_native), _native_case(name, ref_native)
    assert want is not None and _same(got, want)


def test_native_library_is_the_ports_own():
    """Built from the port's copy of the C source into build/, not the JAX
    package's cached library; every entry the bindings name is in it."""
    assert os.path.samefile(port_native._SRC, os.path.join(
        ROOT, "pbwt_tpu_torch", "csrc", "pbwt_native.c"))
    assert port_native._SO.startswith(os.path.join(ROOT, "build",
                                                   "pbwt_tpu_torch"))
    lib = port_native.get_lib()
    assert lib._name == port_native._SO
    with open(port_native._SRC) as f:
        exported = set(re.findall(r"^EXPORT \w+ (\w+)\(", f.read(), re.M))
    with open(port_native.__file__) as f:
        bound = set(re.findall(r"lib\.(\w+)\.argtypes", f.read()))
    assert exported == bound and all(hasattr(lib, n) for n in bound)


@pytest.mark.parametrize("cause", ["missing_source", "failing_compiler"])
def test_get_lib_raises_naming_the_cause(monkeypatch, tmp_path, cause):
    """The port requires its host C runtime: where it cannot be built,
    get_lib() raises RuntimeError naming the cause (a missing source, or
    the compiler's output), and raises again at the next call without
    building again."""
    src = tmp_path / "pbwt_native.c"
    want = "is missing"
    if cause == "failing_compiler":
        src.write_text("long f(void) { return 0; }\n")
        cc = tmp_path / "cc"
        cc.write_text("#!/bin/sh\necho 'no compiler in this test' >&2\n"
                      "exit 1\n")
        cc.chmod(0o755)
        monkeypatch.setenv("CC", str(cc))
        want = "no compiler in this test"
    monkeypatch.setattr(port_native, "_SRC", str(src))
    monkeypatch.setattr(port_native, "_SO",
                        str(tmp_path / "build" / "_pbwt_native.so"))
    monkeypatch.setattr(port_native, "_lib", None)
    monkeypatch.setattr(port_native, "_tried", False)
    monkeypatch.setattr(port_native, "build_log", "")
    for _ in range(2):
        with pytest.raises(RuntimeError, match=want):
            port_native.get_lib()
    assert not os.path.exists(port_native._SO)


# --------------------------------------------------------------- pbwtfile

def _both_pbwts(X):
    return port_pbwt.PBWT.from_haplotypes(X), ref_pbwt.PBWT.from_haplotypes(X)


def _pbwt_fields(p):
    return (p.M, p.N, p.yz, np.asarray(p.aFstart), np.asarray(p.aFend),
            p.chrom,
            None if p.sites is None else [(s.x, s.varD) for s in p.sites],
            p.samples, p.zMissing,
            None if p.missingOffset is None else p.missingOffset.tolist())


@pytest.mark.parametrize("seed,M,N", [(10, 2, 1), (11, 301, 77)])
def test_pbwtfile_write_read(seed, M, N):
    pp, pr = _both_pbwts(_panel(seed, M, N))
    assert _same(_pbwt_fields(pp), _pbwt_fields(pr))
    bp, br = io.BytesIO(), io.BytesIO()
    port_pbwtfile.write_pbwt(pp, bp)
    ref_pbwtfile.write_pbwt(pr, br)
    assert bp.getvalue() == br.getvalue()
    back_p = port_pbwtfile.read_pbwt(io.BytesIO(br.getvalue()))
    back_r = ref_pbwtfile.read_pbwt(io.BytesIO(br.getvalue()))
    assert _same(_pbwt_fields(back_p), _pbwt_fields(back_r))
    assert np.array_equal(back_p.haplotypes(), pr.haplotypes())


# --------------------------------------------------------- vcf and vcfq

def _write_vcf(path, X, missing=False):
    """Phased diploid GT records of haplotype pairs (2i, 2i+1); with
    ``missing``, a missing allele, a haploid call and a two-ALT site."""
    n_s, N = X.shape[0] // 2, X.shape[1]
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n##contig=<ID=20>\n"
                "##FORMAT=<ID=GT,Number=1,Type=String,Description=\"GT\">\n"
                "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{i}" for i in range(n_s)) + "\n")
        for k in range(N):
            gts = [f"{X[2 * i, k]}|{X[2 * i + 1, k]}" for i in range(n_s)]
            alt = "G"
            if missing and k % 5 == 1:
                gts[k % n_s] = ".|1"
            if missing and k % 7 == 2:
                gts[(k + 1) % n_s] = "1"
            if missing and k % 9 == 3:
                alt, gts[0] = "G,T", "2|1"
            f.write(f"20\t{1000 + 10 * k}\t.\tA\t{alt}\t.\tPASS\t.\tGT\t"
                    + "\t".join(gts) + "\n")


def _write_vcfq(path, X):
    with open(path, "w") as f:
        for k in range(X.shape[1]):
            f.write(f"20\t{500 + 3 * k}\tA\tC\t"
                    + "\t".join(str(v) for v in X[:, k]) + "\n")


@pytest.mark.parametrize("device", ["0", "cpu"])
@pytest.mark.parametrize("name,missing", [("a.vcf", False), ("b.vcf", True),
                                          ("c.vcf.gz", True)])
def test_read_vcf_gt(tmp_path, monkeypatch, name, missing, device):
    """On the host route and on the device route (which gathers the columns
    and builds them at once): the same PBWT, sites, samples and missing
    data as the JAX package's streaming reader."""
    path = str(tmp_path / name)
    _write_vcf(path, _panel(12, 60, 45), missing)
    want = _pbwt_fields(ref_vcf.read_vcf_gt(path))
    monkeypatch.setenv("PBWT_TORCH_DEVICE", device)
    got = _pbwt_fields(port_vcf.read_vcf_gt(path))
    assert _same(got, want)
    assert (port_registry.variation_dict._names
            == ref_registry.variation_dict._names)


def test_read_vcf_gt_bgzf_and_bcf(tmp_path):
    """A BGZF VCF written with the port's writer and a BCF written by the
    JAX package read back to the same PBWT."""
    X = _panel(13, 40, 30)
    text = str(tmp_path / "x.vcf")
    _write_vcf(text, X)
    want = _pbwt_fields(ref_vcf.read_vcf_gt(text))
    with open(text, "rb") as f:
        raw = f.read()
    blocks = {}
    for side, bgzf in (("port", port_bgzf), ("ref", ref_bgzf)):
        out = io.BytesIO()
        out.close = lambda: None              # keep the buffer readable
        w = bgzf.BgzfWriter(out)
        w.write(raw)
        w.close()
        blocks[side] = out.getvalue()
    assert blocks["port"] == blocks["ref"]
    assert gzip.decompress(blocks["port"]) == raw
    with open(tmp_path / "x.vcf.gz", "wb") as f:
        f.write(blocks["port"])
    ref_registry.init()
    ref_vcf.write_vcf(ref_vcf.read_vcf_gt(text), str(tmp_path / "x.bcf"),
                      mode="wb")
    for name in ("x.vcf.gz", "x.bcf"):
        port_registry.init()
        got = _pbwt_fields(port_vcf.read_vcf_gt(str(tmp_path / name)))
        assert _same(got[:7], want[:7]), name


@pytest.mark.parametrize("device", ["0", "cpu"])
def test_read_vcfq(tmp_path, monkeypatch, device):
    path = str(tmp_path / "q.vcfq")
    _write_vcfq(path, _panel(14, 130, 70))
    with open(path) as f:
        want = _pbwt_fields(ref_textformats.read_vcfq(f))
    monkeypatch.setenv("PBWT_TORCH_DEVICE", device)
    with open(path) as f:
        got = _pbwt_fields(port_textformats.read_vcfq(f))
    assert _same(got, want)


def test_write_haplotypes():
    pp, pr = _both_pbwts(_panel(15, 75, 31))
    for impute_ref in (False, True):
        sp, sr = io.StringIO(), io.StringIO()
        port_textformats.write_haplotypes(sp, pp, impute_ref)
        ref_textformats.write_haplotypes(sr, pr, impute_ref)
        assert sp.getvalue() == sr.getvalue() and sp.getvalue()


# --------------------------------------------------------------- matchers

def _queries(Xp, Q, seed):
    r = np.random.RandomState(seed)
    Xq = np.empty((Q, Xp.shape[1]), np.uint8)
    for q in range(Q):
        pos = 0
        while pos < Xp.shape[1]:
            seg = r.randint(8, 30)
            Xq[q, pos:pos + seg] = Xp[r.randint(Xp.shape[0]), pos:pos + seg]
            pos += seg
    return Xq


def _with_sites(pbwt_mod, registry, X, dosage_seed=None):
    """X as a PBWT of that package with sites, chrom and samples and, with
    a seed, a dosage track."""
    vid = registry.variation("A", "C")
    vid2 = registry.variation("G", "T")
    sites = [pbwt_mod.Site(x=100 + 7 * i, varD=vid2 if i % 5 == 0 else vid,
                           refFreq=0.125 * (i % 8), imputeInfo=0.5 + i % 2)
             for i in range(X.shape[1])]
    p = pbwt_mod.PBWT.from_haplotypes(X, chrom="20", sites=sites)
    p.samples = [registry.sample_add(f"s{i // 2}")
                 for i in range(p.M)]
    return p


def _add_dosage(p, impute_mod, seed):
    rng = np.random.RandomState(seed)
    zbuf, offsets = bytearray(), []
    Y = p.decoded(True)
    for k in range(p.N):
        d = np.where(rng.random_sample(p.M) < 0.6, Y[k].astype(np.float64),
                     rng.randint(0, 21, size=p.M) / 20.0)
        impute_mod.dosage_store(p, d, k, zbuf, offsets)
    p.zDosage = bytes(zbuf)
    p.dosageOffset = np.array(offsets, np.int64)
    p.isRefFreq = True


@pytest.mark.parametrize("dosage", [False, True])
@pytest.mark.parametrize("mode,name", [("w", "o.vcf"), ("wz", "o.vcf.gz"),
                                       ("wbu", "o.bcf"), ("wb", "o.bcf.gz"),
                                       ("gen", "o.gen")])
def test_writers_match_jax_package(tmp_path, mode, name, dosage):
    """write_vcf in its four modes and write_gen: the bytes of the JAX
    package's writers, with and without a dosage track; the dosage file
    reads back."""
    import pbwt_tpu.algos.impute as ref_impute
    import pbwt_tpu_torch.algos.impute as port_impute
    X = _panel(31, 12, 23)
    out = {}
    for tag, pbwt_mod, registry, vcf, textformats, impute, pbwtfile in (
            ("port", port_pbwt, port_registry, port_vcf, port_textformats,
             port_impute, port_pbwtfile),
            ("ref", ref_pbwt, ref_registry, ref_vcf, ref_textformats,
             ref_impute, ref_pbwtfile)):
        registry.command_line = "-readAll x -writeVcf y"
        p = _with_sites(pbwt_mod, registry, X)
        if dosage:
            _add_dosage(p, impute, 5)
        path = str(tmp_path / f"{tag}.{name}")
        if mode == "gen":
            with open(path, "w") as fp:
                textformats.write_gen(p, fp)
        else:
            vcf.write_vcf(p, path, None, mode)
        with open(path, "rb") as fp:
            out[tag] = fp.read()
        if dosage:
            buf = io.BytesIO()
            pbwtfile.write_dosage(p, buf)
            out[tag + "_dosage"] = buf.getvalue()
            q = pbwt_mod.PBWT(p.M, p.N)
            pbwtfile.read_dosage(q, io.BytesIO(buf.getvalue()))
            assert q.zDosage == p.zDosage
            assert np.array_equal(q.dosageOffset, p.dosageOffset)
            y = p.decoded(True)[3]
            assert np.array_equal(impute.dosage_retrieve(q, y, 3),
                                  impute.dosage_retrieve(p, y, 3))
    assert len(out["port"]) > 100 and out["port"] == out["ref"]
    assert out.get("port_dosage") == out.get("ref_dosage")


def test_crand_is_glibc_rand():
    """The port's glibc rand() stream (its C runtime's): the first draws of
    the unseeded generator, and after reset(12345) the JAX package's class
    draw for draw."""
    import pbwt_tpu.core.crand as ref_crand
    import pbwt_tpu_torch.core.crand as port_crand
    port_crand.reset(1)
    assert [port_crand.rand() for _ in range(3)] == [1804289383, 846930886,
                                                     1681692777]
    port_crand.reset(12345)
    b = ref_crand.GlibcRand(12345)
    assert [port_crand.rand() for _ in range(500)] == [b.next()
                                                       for _ in range(500)]
    assert port_crand.RAND_MAX == ref_crand.RAND_MAX


@pytest.mark.parametrize("which", ["indexed", "sweep", "sweep_callback"])
def test_host_matchers_stdout(capfd, which):
    """-matchIndexed and -matchDynamic on the host: the C sweep printing
    straight to the file descriptor, and the callback route."""
    Xp = _panel(16, 120, 90)
    Xq = _queries(Xp, 7, 17)
    outs = []
    for match, (p, q) in ((port_match, [port_pbwt.PBWT.from_haplotypes(x)
                                        for x in (Xp, Xq)]),
                          (ref_match, [ref_pbwt.PBWT.from_haplotypes(x)
                                       for x in (Xp, Xq)])):
        rows = []
        if which == "indexed":
            match.match_sequences_indexed(p, q)
        elif which == "sweep":
            match.match_sequences_sweep(p, q, match.report_match_stdout)
        else:
            match.match_sequences_sweep(p, q, lambda *r: rows.append(r))
        outs.append((capfd.readouterr().out, rows))
    assert outs[0] == outs[1]
    assert len(outs[0][0].splitlines()) + len(outs[0][1]) > 7


# ------------------------------------------------------------- likelihood

def test_host_likelihood_is_the_same_numpy(capsys):
    X = _panel(18, 24, 20)
    X ^= (np.random.RandomState(19).random_sample(X.shape) < 0.02
          ).astype(np.uint8)
    pp, pr = _both_pbwts(X)
    for theta, rho in ((0.05, 0.01), (0.2, 0.3)):
        assert (port_likelihood.copy_log_likelihood_drop_one(pp, theta, rho)
                == ref_likelihood.copy_log_likelihood_drop_one(pr, theta,
                                                               rho))
    outs = []
    for lk, p in ((port_likelihood, pp), (ref_likelihood, pr)):
        lk.fit_alpha_beta(p, 1)
        lk.fit_alpha_beta(p, 2)
        lk.log_likelihood_copy_model(p, 0.05, 0.01)
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[0].count("\n") == 12


# ------------------------------------------------- routing and the device

def test_from_haplotypes_takes_the_device_build(monkeypatch):
    """Above 2^20 hap-sites PBWT.from_haplotypes builds on the device
    engine (here its plain twins, the CPU named) and gives the host's
    bytes; below, and on the host route, it does not."""
    calls = []
    real = port_build.build_pbwt_device

    def spy(X, device=None):
        calls.append(X.shape)
        return real(X, device)

    monkeypatch.setattr(port_build, "build_pbwt_device", spy)
    X = _panel(20, 8200, 128)                 # 1,049,600 hap-sites
    host = port_pbwt.PBWT.from_haplotypes(X)
    assert calls == []
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    dev = port_pbwt.PBWT.from_haplotypes(X)
    assert calls == [(8200, 128)]
    assert dev.yz == host.yz and np.array_equal(dev.aFend, host.aFend)
    port_pbwt.PBWT.from_haplotypes(X[:, :127])
    assert calls == [(8200, 128)]


def test_read_vcf_gt_takes_the_device_build(tmp_path, monkeypatch):
    """-readVcfGT's reader above 2^20 hap-sites, the CPU named: the columns
    go through the device build and the PBWT equals the streaming host
    reader's."""
    calls = []
    real = port_build.build_pbwt_device
    monkeypatch.setattr(port_build, "build_pbwt_device", lambda X, device=None:
                        calls.append(X.shape) or real(X, device))
    path = str(tmp_path / "big.vcf")
    _write_vcf(path, _panel(22, 4200, 250), missing=True)
    host = _pbwt_fields(port_vcf.read_vcf_gt(path))
    assert calls == []
    port_registry.init()
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    dev = _pbwt_fields(port_vcf.read_vcf_gt(path))
    assert len(calls) == 1 and calls[0][0] == 4200 and calls[0][1] > 250
    assert _same(dev, host)


def test_read_vcf_gt_builds_in_blocks(tmp_path, monkeypatch):
    """-readVcfGT on the device route (the CPU named) with the block made
    small: about 200 sites with missing genotypes and a two-ALT site go
    through BlockBuild in several blocks of whole groups, the prefix array
    carried between them, and -writeAll writes the bytes of the JAX
    package's CLI (the PBWT, sites, samples and missing data)."""
    import pbwt_tpu.cli as ref_cli
    import pbwt_tpu_torch.cli as port_cli
    path = str(tmp_path / "blocks.vcf")
    _write_vcf(path, _panel(24, 90, 196), missing=True)
    monkeypatch.setattr(port_vcf, "BLOCK_BYTES", 64 * 90 + 89)
    sizes = []
    real = port_build.BlockBuild.add
    monkeypatch.setattr(port_build.BlockBuild, "add", lambda self, cols:
                        sizes.append(len(cols)) or real(self, cols))
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    assert port_cli.main(["-readVcfGT", path, "-writeAll",
                          str(tmp_path / "port")]) == 0
    assert sizes == [64, 64, 64, 218 - 3 * 64]
    assert ref_cli.main(["-readVcfGT", path, "-writeAll",
                         str(tmp_path / "ref")]) == 0
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith("ref."))
    assert {"ref.pbwt", "ref.sites", "ref.samples", "ref.missing"} <= set(
        files)
    for f in files:
        assert ((tmp_path / f.replace("ref.", "port.", 1)).read_bytes()
                == (tmp_path / f).read_bytes()), f


def test_no_device_is_an_error_not_the_cpu(monkeypatch):
    """Without a CUDA card the device routes raise; the CPU runs only when
    it is named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PBWT_TORCH_DEVICE")
    assert ops.device_requested() is False
    with pytest.raises(ops.NoDeviceError, match="PBWT_TORCH_DEVICE=cpu"):
        ops.resolve_device(None)
    assert ops.resolve_device("cpu") == torch.device("cpu")
    X = _panel(21, 40, 8)
    with pytest.raises(ops.NoDeviceError):
        port_build.build_pbwt_device(X)
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "1")
    with pytest.raises(ops.NoDeviceError):
        ops.device_requested()
    with pytest.raises(ops.NoDeviceError):
        ops.resolve_device(None)
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    assert ops.device_requested() is True
    assert ops.resolve_device(None) == torch.device("cpu")
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "gpu")
    with pytest.raises(ValueError, match="expected 0, 1 or cpu"):
        ops.device_requested()


IMPORT = re.compile(r"^\s*(?:from|import)\s+(?:jax|pbwt_tpu)\b(?!_)",
                    re.MULTILINE)


def test_port_imports_nothing_of_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "pbwt_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    assert not os.path.exists(os.path.join(ROOT, "pbwt_tpu_torch", "host.py"))
    for path in files:
        with open(path) as f:
            text = f.read()
        found = IMPORT.findall(text)
        assert not found, f"{path} imports {found}"
        assert "pbwt_tpu" not in re.findall(
            r"(?:import_module|__import__)\(\s*[\"'](\w+)", text), path
