"""The port's reference imputation on the CPU against the JAX package's:
the plain twin of kernel K5 against impute_jax.impute_dosages_device (alleles
and quantised dosages) and against the port's host routes (dosages bit for
bit), and reference_impute3 as a whole on all three of the port's routes
against pbwt_tpu.algos.impute's."""

import io

import numpy as np
import pytest
import torch

import pbwt_tpu.algos.impute as ref_impute
import pbwt_tpu.core.pbwt as ref_pbwt
import pbwt_tpu.core.registry as ref_registry
import pbwt_tpu.utils as ref_utils
from pbwt_tpu.ops import impute_jax
import pbwt_tpu_torch.algos.impute as port_impute
import pbwt_tpu_torch.core.native as port_native
import pbwt_tpu_torch.core.pbwt as port_pbwt
import pbwt_tpu_torch.core.registry as port_registry
import pbwt_tpu_torch.utils as port_utils
from pbwt_tpu_torch.ops import impute as port_device
from pbwt_tpu_torch.ops import kernels

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Both packages on their host engines unless a test says otherwise,
    logs discarded, registries fresh."""
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "0")
    monkeypatch.setenv("PBWT_TPU_DEVICE", "0")
    for utils, registry in ((ref_utils, ref_registry),
                            (port_utils, port_registry)):
        registry.init()
        utils.set_log_file(io.StringIO())


def mosaic(seed, M, N, founders=6, switch=0.03):
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((founders, N)) < 0.4).astype(np.uint8)
    src = rng.randint(founders, size=M)
    X = np.empty((M, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(M) < switch
        src[sw] = rng.randint(founders, size=int(sw.sum()))
        X[:, k] = F[src, k]
    return X


def panels(pbwt_mod, registry, Xref, Xq, frame_idx):
    """(p_old, p_ref, p_frame) of that package: the targets observed at the
    frame's sites only."""
    vid = registry.variation("A", "C")
    sites = [pbwt_mod.Site(x=100 + 7 * i, varD=vid)
             for i in range(Xref.shape[1])]
    make = pbwt_mod.PBWT.from_haplotypes
    p_ref = make(Xref, chrom="1", sites=[s.copy() for s in sites])
    p_frame = make(Xref[:, frame_idx], chrom="1",
                   sites=[sites[i].copy() for i in frame_idx])
    p_old = make(Xq[:, frame_idx], chrom="1",
                 sites=[sites[i].copy() for i in frame_idx])
    return p_old, p_ref, p_frame


def problem(seed, Mref, T, N):
    rng = np.random.RandomState(seed)
    Xref, Xq = mosaic(seed + 1, Mref, N), mosaic(seed + 2, T, N, switch=0.06)
    Xq ^= (rng.random_sample(Xq.shape) < 0.02).astype(np.uint8)
    frame_idx = np.sort(rng.choice(N, N // 2, replace=False))
    return Xref, Xq, frame_idx


def vote_inputs(Xref, Xq, frame_idx, drop=None):
    """(segments, kold, ref_freq) as reference_impute3 hands them to the
    vote; `drop` takes every segment of one target away."""
    p_old, p_ref, p_frame = panels(port_pbwt, port_registry, Xref, Xq,
                                   frame_idx)
    segments = port_impute._collect_matches(p_frame, p_old)
    if drop is not None:
        segments = segments[segments[:, 0] != drop]
    kold = port_impute._frame_coordinates(p_ref, p_frame)
    return segments, kold, Xref.mean(axis=0)


def bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.int64)


@pytest.mark.parametrize("Mref,N", [(255, 130), (256, 700), (1023, 130),
                                    (1024, 513)])
def test_vote_twin_matches_jax_and_host(Mref, N):
    """K5's plain twin through impute_dosages_device(device="cpu") against
    the JAX package's device pass (x equal, dosage_encode bytes equal: its
    f32 sums are only close) and against the port's numpy host vote (dosage
    equal bit for bit), with a target that has no match and Nref not a
    multiple of 512."""
    T = 9
    Xref, Xq, frame_idx = problem(Mref + N, Mref, T, N)
    segments, kold, ref_freq = vote_inputs(Xref, Xq, frame_idx, drop=4)
    assert len(segments) > T and N % 512
    before = dict(kernels.LAUNCHES)
    x, dosage, voted = port_device.impute_dosages_device(
        segments, T, Xref, kold, ref_freq, device="cpu")
    assert kernels.LAUNCHES == before    # CPU tensors never reach a kernel
    assert x.dtype == np.uint8 and dosage.dtype == np.float64
    assert voted.dtype == bool and x.shape == dosage.shape == (T, N)
    assert not voted[4].any() and np.array_equal(dosage[4], ref_freq)
    assert voted[[0, 1, 2, 3, 5]].any()
    x_j, dos_j, voted_j = impute_jax.impute_dosages_device(
        segments, T, Xref, kold.astype(np.int32), ref_freq)
    assert np.array_equal(x, x_j) and np.array_equal(voted, voted_j)
    assert np.array_equal(port_impute.dosage_encode(dosage.reshape(-1)),
                          ref_impute.dosage_encode(dos_j.reshape(-1)))
    order = np.lexsort((segments[:, 2], segments[:, 0]))
    x_h, dos_h, voted_h = port_impute._vote_all_sites(
        segments[order], T, Xref, kold, ref_freq)
    assert np.array_equal(bits(dosage), bits(dos_h))
    assert np.array_equal(x, x_h) and np.array_equal(voted, voted_h)


def test_vote_twin_edge_shapes():
    """One target; no segment at all; segments whose weight is never
    positive; the reference rows handed over as a tensor made from
    site-major columns."""
    rng = np.random.RandomState(3)
    Xref = (rng.random_sample((20, 37)) < 0.4).astype(np.uint8)
    kold = ((np.arange(37) + 1) // 2).astype(np.int64)
    freq = Xref.mean(axis=0)
    rows = reference = port_device.reference_rows(
        np.ascontiguousarray(Xref.T), device="cpu")
    assert torch.equal(rows, torch.from_numpy(Xref))
    none = np.zeros((0, 4), np.int64)
    x, dosage, voted = port_device.impute_dosages_device(
        none, 1, reference, kold, freq, device="cpu")
    assert not voted.any() and np.array_equal(bits(dosage[0]), bits(freq))
    assert np.array_equal(x[0], freq > 0.5)
    # [start, end) = [5, 6): (k - 5)(6 - k) is never positive at an integer k
    thin = np.array([[0, 3, 5, 6], [0, 7, 2, 9]], np.int64)
    x, dosage, voted = port_device.impute_dosages_device(
        thin, 1, Xref, kold, freq, device="cpu")
    inside = (kold > 2) & (kold < 9)
    assert np.array_equal(voted[0], inside)
    assert np.array_equal(dosage[0][inside], Xref[7][inside].astype(float))


def site_fields(p_new, p_ref):
    return (p_new.M, p_new.N, p_new.yz, p_new.zDosage,
            np.asarray(p_new.dosageOffset).tolist(),
            np.asarray(p_new.aFend).tolist(),
            [s.refFreq for s in p_ref.sites],
            [s.imputeInfo for s in p_ref.sites])


@pytest.mark.parametrize("route", ["0", "cpu", "no_runtime"])
@pytest.mark.parametrize("seed,Mref,T,N", [(0, 40, 6, 120), (5, 300, 21, 97)])
def test_reference_impute3_matches_jax_package(monkeypatch, route, seed, Mref,
                                               T, N):
    """reference_impute3 of the port on its host C route, on the device
    route (K5's twin on CPU tensors) and without the C runtime, against
    pbwt_tpu.algos.impute's: yz, zDosage, dosageOffset, aFend, and every
    site's refFreq and imputeInfo, exactly."""
    Xref, Xq, frame_idx = problem(seed, Mref, T, N)
    po_j, pr_j, pf_j = panels(ref_pbwt, ref_registry, Xref, Xq, frame_idx)
    want = ref_impute.reference_impute3(po_j, pr_j, pf_j)
    p_old, p_ref, p_frame = panels(port_pbwt, port_registry, Xref, Xq,
                                   frame_idx)
    if route == "no_runtime":
        monkeypatch.setattr(port_native, "get_lib", lambda: None)
    else:
        monkeypatch.setenv("PBWT_TORCH_DEVICE", route)
    votes = []
    real = port_device.impute_vote
    monkeypatch.setattr(port_device, "impute_vote",
                        lambda *a: votes.append(1) or real(*a))
    got = port_impute.reference_impute3(p_old, p_ref, p_frame)
    assert len(votes) == (route == "cpu")
    assert got.isRefFreq and got.dosageOffset is not None
    assert site_fields(got, p_ref) == site_fields(want, pr_j)
    assert any(s.imputeInfo not in (0.0, 1.0) for s in p_ref.sites)


def test_self_impute_is_refused():
    """impute_missing refuses a panel without missing data as the JAX
    package does: the same panel back and the same log line."""
    Xref, Xq, frame_idx = problem(1, 20, 4, 40)
    logs = []
    for pbwt_mod, registry, utils, impute in (
            (port_pbwt, port_registry, port_utils, port_impute),
            (ref_pbwt, ref_registry, ref_utils, ref_impute)):
        _, p_ref, _ = panels(pbwt_mod, registry, Xref, Xq, frame_idx)
        log = io.StringIO()
        utils.set_log_file(log)
        assert impute.impute_missing(p_ref) is p_ref
        logs.append(log.getvalue())
    assert logs[0] == logs[1] and "can't find missing data" in logs[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_dosage_codec_matches_jax_package(seed):
    rng = np.random.RandomState(seed)
    d = np.concatenate([rng.random_sample(500), [0.0, 1.0, 0.5, 0.05, 0.95],
                        np.zeros(40000), rng.randint(0, 21, 300) / 20.0])
    assert np.array_equal(port_impute.dosage_encode(d),
                          ref_impute.dosage_encode(d))
    p = port_pbwt.PBWT(len(d), 1)
    q = ref_pbwt.PBWT(len(d), 1)
    zp, zq, op, oq = bytearray(), bytearray(), [], []
    port_impute.dosage_store(p, d, 0, zp, op)
    ref_impute.dosage_store(q, d, 0, zq, oq)
    assert zp == zq and op == oq
    y = (d > 0.5).astype(np.uint8)
    for pp, z, mod in ((p, zp, port_impute), (q, zq, ref_impute)):
        pp.zDosage, pp.dosageOffset = bytes(z), np.array([0], np.int64)
    assert np.array_equal(port_impute.dosage_retrieve(p, y, 0),
                          ref_impute.dosage_retrieve(q, y, 0))
