"""The imputation cell's yardstick on the CPU: the plain reference of
reference imputation against the port's host C route (pbwt's referenceImpute3
bytes), K5's roofline count against chip_smoke.py's, the cell's typed
sites and its decoder of a result, and the cell's comparison failing its
control (the reference in float32), the reference with ties dropped and
faults planted in the program."""

import io
import random

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers.impute import decoded, typed_sites
from benchmark.reference import impute as plain
from benchmark.rooflines import k5_impute_vote

CELL = "hrc_impute.gwas_t2000"


@pytest.fixture
def port(monkeypatch):
    """The port's host engine, its logs discarded, its registry fresh."""
    from pbwt_tpu_torch import utils
    from pbwt_tpu_torch.core import registry
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "0")
    registry.init()
    utils.set_log_file(io.StringIO())


def toy(seed, Mref, N, T, every):
    """(Xref, Z, typed mask) of random panels with rows of all 0s and all
    1s (every allele somewhere), and targets copied from the panel in runs
    with a few flips, typed at every `every`-th site from a seeded start."""
    rng = np.random.RandomState(seed)
    X = (rng.random_sample((Mref, N)) < rng.uniform(0.1, 0.6, N)).astype(np.uint8)
    X[0], X[1] = 0, 1
    Z = np.empty((T, N), np.uint8)
    for t in range(T):
        k = 0
        while k < N:
            n = rng.randint(3, 25)
            Z[t, k:k + n] = X[rng.randint(Mref), k:k + n]
            k += n
    Z ^= (rng.random_sample(Z.shape) < 0.03).astype(np.uint8)
    typed = np.zeros(N, bool)
    typed[rng.randint(every)::every] = True
    return X, Z, typed


def host_result(X, Z, typed):
    """The port's host C route (pbwt's bytes) on a toy problem: its result,
    and the reference's sites, which hold the info scores."""
    from pbwt_tpu_torch.algos import impute
    from pbwt_tpu_torch.core import registry
    from pbwt_tpu_torch.core.pbwt import PBWT, Site
    vid = registry.variation("A", "C")
    sites = [Site(x=10 + 3 * k, varD=vid) for k in range(X.shape[1])]
    fsites = [s for s, t in zip(sites, typed) if t]
    p_ref = PBWT.from_haplotypes(X, chrom="1", sites=sites)
    p_frame = p_ref.select_sites(fsites, keep_old=True)
    p_old = PBWT.from_haplotypes(np.ascontiguousarray(Z[:, typed]), chrom="1",
                                 sites=[s.copy() for s in fsites])
    return impute.reference_impute3(p_old, p_ref, p_frame), p_ref.sites


def host_imputed(X, Z, typed):
    """(alleles, dosage codes) of every target on the host C route."""
    return decoded(host_result(X, Z, typed)[0], np.arange(len(Z)))


def host_info(X, Z, typed):
    """Each site's info score on the host C route (0 where none voted)."""
    return np.array([s.imputeInfo for s in host_result(X, Z, typed)[1]])


@pytest.mark.parametrize("seed,Mref,N,T,every", [
    (1, 12, 40, 5, 2), (2, 40, 150, 9, 4), (3, 90, 333, 7, 8),
    (4, 300, 600, 6, 16)])
def test_reference_equals_the_host_c_route(port, seed, Mref, N, T, every):
    X, Z, typed = toy(seed, Mref, N, T, every)
    want_al, want_co = host_imputed(X, Z, typed)
    al, co, dosage, voted = plain.impute(torch.from_numpy(np.ascontiguousarray(X.T)),
                                  torch.from_numpy(typed),
                                  torch.from_numpy(np.ascontiguousarray(Z[:, typed])))
    assert np.array_equal(al.numpy(), want_al)
    assert np.array_equal(co.numpy(), want_co)
    assert (co > 0).any() and ((dosage > 0) & (dosage < 1)).any()
    one = plain.impute(torch.from_numpy(np.ascontiguousarray(X.T)),
                       torch.from_numpy(typed),
                       torch.from_numpy(np.ascontiguousarray(Z[:, typed])),
                       one_per_match=True)
    assert not torch.equal(one[2], dosage)
    want_info = host_info(X, Z, typed)
    info = plain.info_scores(al, dosage, voted).nan_to_num(0.0).numpy()
    assert np.abs(info - want_info).max() < 1e-10
    low = plain.impute(torch.from_numpy(np.ascontiguousarray(X.T)),
                       torch.from_numpy(typed),
                       torch.from_numpy(np.ascontiguousarray(Z[:, typed])),
                       dtype=torch.float32)
    low_info = plain.info_scores(low[0], low[2], low[3]).nan_to_num(0.0)
    assert np.abs(low_info.double().numpy() - want_info).max() > 1e-10


def test_dosage_codes_are_pbwts():
    """The 6-level code against the port's dosage_encode (pbwtImpute.c)."""
    from pbwt_tpu_torch.algos.impute import dosage_encode
    d = torch.tensor([0.0, 1.0, 0.5, 0.05, 0.95, 0.0000001, 0.4000001,
                      0.5000001, 0.15, 0.85, 0.25, 0.3333333333, 0.9999])
    d = torch.cat([d, torch.rand(10_000, dtype=torch.float64,
                                 generator=torch.Generator().manual_seed(3))])
    assert np.array_equal(plain.dosage_codes(d.double()).numpy(),
                          dosage_encode(d.double().numpy()))


def test_k5_bound_is_chip_smokes():
    """K5's bound at chip_smoke.py's imputation (T = 2,000, Nref = 16,384,
    302,381,464 covering pairs): 0.1881 ms by bytes, 0.0722 by operations
    (PERF.md's kernel table)."""
    pairs, T, Nref = 302_381_464, 2000, 16_384
    nbytes, ops = k5_impute_vote.work(pairs, T, Nref)
    assert round(1e3 * k5_impute_vote.bound(pairs, T, Nref), 4) == 0.1881
    assert round(1e3 * ops / k5_impute_vote.PEAKS["f64_ops_per_s"], 4) == 0.0722
    assert nbytes == pairs + 10 * T * Nref


def test_covering_pairs_brute_force():
    rng = random.Random(4)
    kold = torch.tensor(sorted(rng.randrange(0, 40) for _ in range(300)))
    s = torch.tensor([rng.randrange(0, 40) for _ in range(200)], dtype=torch.int32)
    e = s + torch.tensor([rng.randrange(0, 15) for _ in range(200)], dtype=torch.int32)
    want = sum(int(((kold > a) & (kold < b)).sum()) for a, b in zip(s, e))
    assert int(k5_impute_vote.covering_pairs(kold.int(), s, e)) == want


def test_typed_sites():
    cfg = {"sites": 4096, "assumed": {"typed_every": 64,
                                      "typed_frequency": [0.05, 0.95]}}
    M = 1000
    ones = torch.randint(0, M + 1, (4096,), generator=torch.Generator().manual_seed(2))
    got = typed_sites(ones, M, cfg, 2**33 + 5)
    assert len(got) == 64 and np.all(np.diff(got) > 0)
    f = ones.numpy()[got] / M
    assert ((f >= 0.05) & (f <= 0.95)).all()
    assert np.array_equal(got, typed_sites(ones, M, cfg, 2**33 + 5))
    assert not np.array_equal(got, typed_sites(ones, M, cfg, 2**33 + 6))
    with pytest.raises(ValueError):
        typed_sites(torch.zeros(4096, dtype=torch.int64), M, cfg, 1)


def test_decoded_reads_the_ports_streams(port):
    """decoded() against the port's decoders: the haplotypes, and each
    site's dosages (dosage_retrieve on the sorted column) coded again; a
    truncated dosage stream reads as codes of 255."""
    from pbwt_tpu_torch.algos.impute import dosage_encode, dosage_retrieve
    from pbwt_tpu_torch.core import engine
    X, Z, typed = toy(5, 60, 200, 40, 4)
    from pbwt_tpu_torch.algos import impute
    from pbwt_tpu_torch.core import registry
    from pbwt_tpu_torch.core.pbwt import PBWT, Site
    vid = registry.variation("A", "C")
    sites = [Site(x=10 + 3 * k, varD=vid) for k in range(200)]
    fsites = [s for s, t in zip(sites, typed) if t]
    p_ref = PBWT.from_haplotypes(X, chrom="1", sites=sites)
    p_old = PBWT.from_haplotypes(np.ascontiguousarray(Z[:, typed]), chrom="1",
                                 sites=[s.copy() for s in fsites])
    p_new = impute.reference_impute3(
        p_old, p_ref, p_ref.select_sites(fsites, keep_old=True))
    targets = [0, 3, 17, 39]
    al, co = decoded(p_new, targets)
    assert np.array_equal(al, p_new.haplotypes()[targets])
    Y, a = p_new.decoded(True), np.arange(40)
    for k in range(200):
        nat = np.empty(40, np.uint8)
        nat[a] = dosage_encode(dosage_retrieve(p_new, Y[k], k))
        assert np.array_equal(co[:, k], nat[targets])
        a = engine.forwards_a(a, Y[k])
    p_new.zDosage = p_new.zDosage[:-1]
    assert (decoded(p_new, targets)[1] == 255).all()


def run(base, control=False):
    return harness.run_cell(harness.load_cell(CELL, base), 2**31 + 29, 0.3,
                            False, torch.device("cpu"), 0.0,
                            log=lambda *a, **k: None, control=control)


def failed(checks):
    return any(c["value"] > c["limit"] for c in checks.values())


def test_control_fails(tiny):
    """The control, the reference in float32, fails by its info scores."""
    res = run(tiny, control=True)
    assert res["correct"], res["checks"]
    assert failed(res["control"]), res["control"]
    info = res["control"]["info_max_abs_diff"]
    assert info["value"] > info["limit"], res["control"]


def test_ties_dropped_fails(tiny, monkeypatch):
    """The reference keeping one haplotype a match, in the program's place,
    fails (at full size by thousands of alleles and codes; at this size the
    sampled targets' may all agree, and the info scores do not)."""
    from benchmark.drivers.impute import Driver
    monkeypatch.setattr(Driver, "control",
                        lambda self: self._compare(one_per_match=True))
    res = run(tiny, control=True)
    assert res["correct"], res["checks"]
    assert failed(res["control"]), res["control"]


def dropped_segments(mp):
    """Each target's last segment left out of the vote."""
    from pbwt_tpu_torch.ops import impute
    real = impute.segment_columns

    def fewer(segments, n_targets):
        keep = np.ones(len(segments), bool)
        last = np.unique(segments[:, 0], return_index=True)[1]
        keep[last] = False
        return real(segments[keep], n_targets)
    mp.setattr(impute, "segment_columns", fewer)


def next_donor(mp):
    """Each segment's donor the next haplotype."""
    from pbwt_tpu_torch.ops import impute
    real = impute.segment_columns

    def shifted(segments, n_targets):
        off, jref, s, e = real(segments, n_targets)
        return off, (jref + 1) % 600, s, e          # the tiny panel's rows
    mp.setattr(impute, "segment_columns", shifted)


def frame_shifted(mp):
    """Every frame coordinate one site late."""
    from pbwt_tpu_torch.algos import impute
    real = impute._frame_coordinates
    mp.setattr(impute, "_frame_coordinates",
               lambda p_ref, p_frame: np.concatenate(
                   [[0], real(p_ref, p_frame)[:-1]]))


@pytest.mark.parametrize("fault", [dropped_segments, next_donor,
                                   frame_shifted])
def test_faults_fail(tiny, monkeypatch, fault):
    fault(monkeypatch)
    res = run(tiny)
    assert not res["correct"] and failed(res["checks"]), res["checks"]
