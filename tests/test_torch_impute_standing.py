"""Reference imputation against a standing panel (ReferenceImputer) on the
CPU, the device routes on CPU tensors: its output against the plain
reference of the benchmark (benchmark/reference/impute.py), the frame's
matches from the standing DeviceMatcher against the host sweep's,
-referenceImpute through the CLI on the device route against the host C
route byte for byte, results that own their sites, and the imputer's spans
and counters."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.drivers.impute import decoded
from benchmark.reference import impute as plain
from pbwt_tpu_torch import tracing, utils
from pbwt_tpu_torch.algos import impute, match as matchmod
from pbwt_tpu_torch.core import native, registry
from pbwt_tpu_torch.core.pbwt import PBWT, Site
from pbwt_tpu_torch.io import pbwtfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MREF, NREF, STEP, T = 600, 2048, 16, 200     # a frame of 128 typed sites


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    registry.init()
    utils.set_log_file(io.StringIO())
    tracing.reset()
    yield
    tracing.reset()


def mosaics(rng, F, rows, switch=0.004, noise=0.005):
    """Rows copying founders F, switching with the given rate a site, with
    allele noise on top."""
    K, N = F.shape
    src = rng.randint(K, size=rows)
    X = np.empty((rows, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(rows) < switch
        src[sw] = rng.randint(K, size=int(sw.sum()))
        X[:, k] = F[src, k]
    return X ^ (rng.random_sample(X.shape) < noise).astype(np.uint8)


def problem(seed, Mref=MREF, N=NREF, T=T, step=STEP):
    """(Xref, Xq, typed indices, p_ref, p_frame, p_old): targets typed at
    every step-th site, mosaics of the panel's founders."""
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((40, N)) < rng.beta(0.2, 0.8, N)).astype(np.uint8)
    Xref, Xq = mosaics(rng, F, Mref), mosaics(rng, F, T)
    typed = np.arange(seed % step, N, step)
    vid = registry.variation("A", "C")
    sites = [Site(x=100 + 7 * k, varD=vid) for k in range(N)]
    p_ref = PBWT.from_haplotypes(Xref, chrom="1", sites=[s.copy() for s in sites])
    p_frame = p_ref.select_sites([sites[k] for k in typed], keep_old=True)
    p_old = PBWT.from_haplotypes(np.ascontiguousarray(Xq[:, typed]), chrom="1",
                                 sites=[sites[k].copy() for k in typed])
    return Xref, Xq, typed, p_ref, p_frame, p_old


@pytest.mark.parametrize("seed", [0, 7])
def test_imputer_equals_plain_reference(seed):
    """Every imputed allele and dosage code of every target, decoded from
    the result's pack3 and dosage streams, is the plain reference's, and
    every site's info score within 1e-10 of its."""
    Xref, Xq, typed, p_ref, p_frame, p_old = problem(seed)
    imputer = impute.ReferenceImputer(p_ref, p_frame, "cpu")
    assert imputer.matcher is not None          # Mref > DEVICE_MIN_M
    got = imputer.impute(p_old)
    targets = np.arange(T)
    alleles, codes = decoded(got, targets)
    assert np.array_equal(alleles, got.haplotypes())
    mask = torch.zeros(NREF, dtype=torch.bool)
    mask[torch.from_numpy(typed)] = True
    want_al, want_co, dosage, voted = plain.impute(
        torch.from_numpy(np.ascontiguousarray(Xref.T)), mask,
        torch.from_numpy(np.ascontiguousarray(Xq[:, typed])))
    assert np.array_equal(alleles, want_al.numpy())
    assert np.array_equal(codes, want_co.numpy())
    # info scores: sums of f64 dosages over the targets, in another order
    info = plain.info_scores(want_al, dosage, voted).nan_to_num(0.0).numpy()
    got_info = np.array([s.imputeInfo for s in got.sites])
    assert np.abs(got_info - info).max() < 1e-10 and (info != 0).sum() > 100
    # typed sites hold sums over many segments; untyped ones still vote
    assert 0 < (codes > 0).sum() and ((dosage > 0) & (dosage < 1)).any()


def test_frame_rows_of_the_matcher_equal_the_sweep():
    """The standing frame matcher's rows are the host sweep's, as a set."""
    _, _, _, p_ref, p_frame, p_old = problem(3)
    sweep = matchmod.match_sequences_sweep_rows(p_frame, p_old)
    imputer = impute.ReferenceImputer(p_ref, p_frame, "cpu")
    rows = imputer.matcher.match(p_old.haplotypes()).astype(np.int64)
    assert len(rows) == len(sweep) > 4 * T
    assert set(map(tuple, rows.tolist())) == set(map(tuple, sweep.tolist()))


def test_device_route_takes_no_host_sweep(monkeypatch):
    """reference_impute3 on the device route matches on the standing
    DeviceMatcher, never through the host's C sweep, decodes the panel once
    and writes the host C route's bytes."""
    _, _, _, p_ref, p_frame, p_old = problem(5)
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "0")
    want = impute.reference_impute3(p_old, p_ref, p_frame)
    info = [(s.refFreq, s.imputeInfo) for s in p_ref.sites]
    for s in p_ref.sites:
        s.refFreq = s.imputeInfo = 0.0
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")

    def refused(*a, **k):
        raise AssertionError("the host sweep ran on the device route")
    monkeypatch.setattr(native, "sweep_match_packed", refused)
    decodes = []
    real = native.natural_cols
    monkeypatch.setattr(native, "natural_cols",
                        lambda *a, **k: decodes.append(a[1]) or real(*a, **k))
    got = impute.reference_impute3(p_old, p_ref, p_frame)
    assert NREF in decodes and decodes.count(NREF) == 1
    assert (got.yz, got.zDosage, list(got.dosageOffset), list(got.aFend)) == \
        (want.yz, want.zDosage, list(want.dosageOffset), list(want.aFend))
    assert [(s.refFreq, s.imputeInfo) for s in p_ref.sites] == info


def test_results_own_their_sites():
    """A second call, on other targets, leaves the first result's info
    scores and refFreq and the reference's sites as they were; the same
    targets again give the same result."""
    _, _, _, p_ref, p_frame, p_old = problem(11)
    _, _, _, _, _, p_other = problem(12)
    before = [(s.refFreq, s.imputeInfo) for s in p_ref.sites]
    imputer = impute.ReferenceImputer(p_ref, p_frame, "cpu")
    first = imputer.impute(p_old)
    kept = [(s.refFreq, s.imputeInfo) for s in first.sites]
    second = imputer.impute(p_other)
    assert [(s.refFreq, s.imputeInfo) for s in first.sites] == kept
    assert [(s.refFreq, s.imputeInfo) for s in second.sites] != kept
    assert all(a is not b for a, b in zip(first.sites, second.sites))
    assert [(s.refFreq, s.imputeInfo) for s in p_ref.sites] == before
    again = imputer.impute(p_old)
    assert (again.yz, again.zDosage) == (first.yz, first.zDosage)
    assert [(s.refFreq, s.imputeInfo) for s in again.sites] == kept
    assert first.chrom == "1" and first.N == NREF and first.M == T


def test_imputer_spans_and_counters():
    """Set-up is setup.imputer with .rows, .frame and .matcher; a call is
    the root ops.impute, its stages its children, the matcher's own spans
    inside .match; the counters hold the call's targets, segments,
    reference sites and genotypes."""
    _, _, _, p_ref, p_frame, p_old = problem(2)
    imputer = impute.ReferenceImputer(p_ref, p_frame, "cpu")
    tot = tracing.totals()
    assert {"setup.imputer", "setup.imputer.rows", "setup.imputer.frame",
            "setup.imputer.matcher", "setup.matcher"} <= set(tot)
    assert tot["setup.imputer"].root_s == tot["setup.imputer"].seconds > 0
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        imputer.impute(p_old)
    recs = tracing.records()
    root, = [r for r in recs if r.name == "ops.impute"]
    assert root.parent is None
    stages = {r.name for r in recs if r.parent == root.id}
    assert stages == {f"ops.impute.{s}" for s in (
        "targets", "match", "segments", "vote", "download", "sums", "emit")}
    match_id, = [r.id for r in recs if r.name == "ops.impute.match"]
    assert [r.parent for r in recs if r.name == "ops.match"] == [match_id]
    assert all(r.root == root.id for r in recs)
    cnt = tracing.counters()
    rows = cnt["ops.match.rows"]
    assert cnt["ops.impute.targets"] == T and cnt["ops.impute.segments"] == rows
    assert cnt["ops.impute.ref_sites"] == NREF
    assert cnt["ops.impute.genotypes"] == T * NREF
    inside = sum(r.seconds for r in recs if r.parent == root.id)
    assert inside <= root.seconds


def _cli(args, device, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PBWT_TORCH_DEVICE"}
    env.update(PBWT_TORCH_DEVICE=device, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-m", "pbwt_tpu_torch", *args],
                         capture_output=True, env=env, cwd=cwd, timeout=300)
    assert res.returncode == 0, res.stderr.decode()
    return res


def test_cli_device_route_writes_the_host_routes_bytes(tmp_path):
    """-referenceImpute through the CLI on the device route (the standing
    imputer on CPU tensors, its frame matched by DeviceMatcher, as its
    -profile spans show) and on the host C route: .pbwt, .sites and
    .dosage byte for byte."""
    _, _, _, p_ref, _, p_old = problem(4, T=60)
    pbwtfile.write_all(p_ref, str(tmp_path / "R"))
    pbwtfile.write_all(p_old, str(tmp_path / "T"))
    for device in ("cpu", "0"):
        (tmp_path / device).mkdir()
        _cli(["-readAll", "../T", "-profile", "prof", "-referenceImpute",
              "../R", "-writeAll", "OUT"], device, tmp_path / device)
    for ext in ("pbwt", "sites", "dosage"):
        a = (tmp_path / "cpu" / f"OUT.{ext}").read_bytes()
        assert a and a == (tmp_path / "0" / f"OUT.{ext}").read_bytes(), ext
    spans = {line.split("\t")[1] for line in (
        tmp_path / "cpu" / "prof" / "pbwt_torch_spans.tsv").read_text()
        .splitlines()[1:] if line.startswith("span")}
    assert {"ops.impute", "ops.impute.match", "ops.match",
            "setup.imputer"} <= spans
