"""The port's device construction on the CPU (plain twin of K1) against the
JAX package's build_pbwt_device and the host engine: the same pack3 bytes,
final prefix array and zero counts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pbwt_tpu.core import engine
from pbwt_tpu.ops import build as jbuild
from pbwt_tpu_torch.ops import build

torch.set_num_threads(1)


def rand_haps(seed, M, N, maf=0.3):
    rng = np.random.RandomState(seed)
    return (rng.random_sample((M, N)) < maf).astype(np.uint8)


def _check_host(X, yz, a_end, counts):
    M, N = X.shape
    yz_h, a_h = engine.build_from_haplotypes(X)
    assert yz == yz_h
    assert np.array_equal(a_end, a_h)
    a = np.arange(M)
    for k in range(N):
        y = X[a, k]
        assert counts[k] == int((y == 0).sum()), k
        a = engine.forwards_a(a, y)


@pytest.mark.parametrize("seed,M,N", [(0, 24, 40), (6, 16, 70), (7, 32, 32),
                                      (1, 30, 40)])
def test_build_matches_jax_and_host(seed, M, N):
    X = rand_haps(seed, M, N)
    yz, a_end, counts = build.build_pbwt_device(X, device="cpu")
    yz_j, a_j, counts_j = jbuild.build_pbwt_device(X, multiple=8)
    assert yz == yz_j
    assert np.array_equal(a_end, a_j)
    assert np.array_equal(counts, np.asarray(counts_j)[:N])
    _check_host(X, yz, a_end, counts)


@pytest.mark.parametrize("M,N", [(24, 40), (30, 37), (256, 64), (255, 70)])
def test_group_words_match_jax(M, N):
    """Row-wise word packing == the JAX package's column-wise packing,
    all-ones pad rows and pad sites included."""
    X = rand_haps(M + N, M, N)
    cols, Mp = jbuild.prepare_columns(X)
    assert np.array_equal(build.pack_group_words(X, Mp),
                          jbuild.pack_group_words(cols))


@pytest.mark.parametrize("M", [255, 256, 4095, 4097])
def test_build_tile_edges_match_host(M):
    X = rand_haps(M, M, 37, maf=0.2)
    X[: M // 4] = X[0]                    # duplicate rows: long equal runs
    _check_host(X, *build.build_pbwt_device(X, device="cpu"))


@pytest.mark.parametrize("Ng,Mp", [(2, 256), (3, 512), (2, 2048)])
def test_build_scan_grouped_matches_jax(Ng, Mp):
    """The multi-group wrapper (on the CPU its twin, the loop of the plain
    group partition) against the JAX package's build_scan_grouped on the
    same words: sorted columns, zero counts, the final prefix array and,
    without divergence, the untouched start divergence array."""
    rng = np.random.RandomState(Ng * Mp)
    W = rng.randint(0, 2**32, size=(Ng, Mp), dtype=np.uint32).astype(np.int32)
    W[:, Mp - 7:] = -1                    # all-ones pad rows
    W[Ng - 1] |= np.int32(-1 << 20)       # all-ones pad sites
    a0 = rng.permutation(Mp).astype(np.int32)
    ycols, counts, a_end, d_end = build.build_scan_grouped(
        torch.from_numpy(W), torch.from_numpy(a0))
    ybits_j, counts_j, a_j, d_j = jbuild.build_scan_grouped(jnp.asarray(W),
                                                            jnp.asarray(a0))
    assert ycols.shape == (Ng * 32, Mp // 32) and ycols.dtype == torch.int32
    assert np.array_equal(build.unpack_columns(ycols.numpy(), Mp),
                          jbuild.unpack_bits_host(np.asarray(ybits_j), Mp))
    assert np.array_equal(counts.numpy(), np.asarray(counts_j))
    assert np.array_equal(a_end.numpy(), np.asarray(a_j))
    assert d_end.dtype == torch.int32
    assert np.array_equal(d_end.numpy(), np.asarray(d_j))


def _host_ad_end(X):
    """(a, d) after every site of X by the port's host engine."""
    from pbwt_tpu_torch.core import engine as tengine
    M, N = X.shape
    a = np.arange(M, dtype=np.int32)
    d = np.zeros(M + 1, np.int32)
    d[0] = d[M] = 1
    for k in range(N):
        a, d = tengine.forwards_ad(a, d, X[a, k], k)
    return a, d


# budgets of the divergence pass: one chunk for all groups; one group a chunk
@pytest.mark.parametrize("chunk_bytes", [1 << 30, 1])
@pytest.mark.parametrize("seed,M,N", [(2, 250, 70), (3, 256, 90), (4, 30, 40)])
def test_build_scan_grouped_with_divergence(monkeypatch, chunk_bytes, seed,
                                            M, N):
    """with_divergence=True at N % 32 != 0 over 2-3 groups: the four values
    of the JAX package's build_scan_grouped, d_end[0] restored to
    n_sites + 1, and the end state of the port's engine.forwards_ad on the
    real rows; the same whether the divergence pass takes one chunk or
    several."""
    monkeypatch.setattr(build, "DIVERGENCE_BYTES", chunk_bytes)
    calls = []
    real = build.ad_trajectory
    monkeypatch.setattr(
        build, "ad_trajectory",
        lambda W, a, d, first, out: calls.append((W.shape[0], first))
        or real(W, a, d, first, out))
    X = rand_haps(seed, M, N)
    X[: M // 4] = X[0]                    # duplicate rows: deep divergence
    Mp = build.pad_to(M)
    W = build.pack_group_words(X, Mp)
    a0 = np.arange(Mp, dtype=np.int32)
    got = build.build_scan_grouped(torch.from_numpy(W), torch.from_numpy(a0),
                                   with_divergence=True, n_sites=N)
    Ng = -(-N // 32)
    assert calls == ([(Ng, 0)] if chunk_bytes > 1
                     else [(1, 32 * g) for g in range(Ng)])
    ybits_j, counts_j, a_j, d_j = jbuild.build_scan_grouped(
        jnp.asarray(W), jnp.asarray(a0), with_divergence=True, n_sites=N)
    ycols, counts, a_end, d_end = got
    assert np.array_equal(build.unpack_columns(ycols.numpy(), Mp),
                          jbuild.unpack_bits_host(np.asarray(ybits_j), Mp))
    assert np.array_equal(counts.numpy(), np.asarray(counts_j))
    assert np.array_equal(a_end.numpy(), np.asarray(a_j))
    assert np.array_equal(d_end.numpy(), np.asarray(d_j))
    assert int(d_end[0]) == N + 1
    a_h, d_h = _host_ad_end(X)
    assert np.array_equal(a_end.numpy()[:M], a_h)
    assert np.array_equal(d_end.numpy()[:M], d_h[:M])
    # without n_sites the pad sites' sentinel stands
    raw = build.build_scan_grouped(torch.from_numpy(W), torch.from_numpy(a0),
                                   with_divergence=True)[3]
    assert int(raw[0]) == 32 * Ng + 1 and torch.equal(raw[1:], d_end[1:])


def test_build_pads_rows_to_the_multiple_asked_for(monkeypatch):
    """build_pbwt_device(multiple=1024) pads to 1,024 rows and gives the
    bytes of the default and of the JAX package's at that multiple."""
    shapes = []
    real = build.group_scan
    monkeypatch.setattr(build, "group_scan",
                        lambda *a: shapes.append(a[0].shape) or real(*a))
    X = rand_haps(9, 300, 40)
    got = build.build_pbwt_device(X, device="cpu", multiple=1024)
    want = build.build_pbwt_device(X, device="cpu")
    assert shapes == [(2, 1024), (2, 512)]
    yz_j, a_j, counts_j = jbuild.build_pbwt_device(X, multiple=1024)
    for g, w, j in zip(got, want, (yz_j, a_j, np.asarray(counts_j)[:40])):
        assert np.array_equal(g, w) and np.array_equal(g, j)
    _check_host(X, *got)


def test_build_takes_the_multi_group_wrapper(monkeypatch):
    """build_pbwt_device hands all groups to the wrapper in one call."""
    calls = []
    real = build.group_scan
    monkeypatch.setattr(build, "group_scan",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    X = rand_haps(3, 30, 70)
    yz, a_end, counts = build.build_pbwt_device(X, device="cpu")
    assert calls == [(3, 256)]
    _check_host(X, yz, a_end, counts)


# n a multiple of 32 and not; M a multiple of 256, of 4 alone and of neither
# (70 also at Mp = M, no pad rows and a width that is not a multiple of 4)
@pytest.mark.parametrize("n", [64, 32, 100, 7])
@pytest.mark.parametrize("M,Mp", [(256, 256), (68, 256), (70, 256), (70, 70),
                                  (512, 768)])
def test_pack_columns_twin_matches_numpy(n, M, Mp):
    """The plain twin of k1_pack_columns gives pack_column_words' words,
    all-ones pad rows and pad sites included, on bytes other than 0 and 1
    (a byte counts as 1 when it is not 0)."""
    rng = np.random.RandomState(n * M + Mp)
    cols = (rng.randint(0, 2, (n, M)) * rng.randint(1, 256, (n, M))) \
        .astype(np.uint8)
    cols[:, :3] = [0, 1, 255]
    got = build.pack_columns(torch.from_numpy(cols), Mp)
    assert got.dtype == torch.int32 and got.shape == (-(-n // 32), Mp)
    assert np.array_equal(got.numpy(), build.pack_column_words(cols, Mp))
    assert np.array_equal(got.numpy(),
                          build.pack_column_words(cols != 0, Mp))


@pytest.mark.parametrize("M,sizes", [(70, (64, 32, 37)), (256, (96, 4)),
                                     (68, (32, 32, 32))])
@pytest.mark.parametrize("one", [1, 9])
def test_block_build_matches_build_pbwt_device(M, sizes, one):
    """BlockBuild on the CPU (the packing's plain twin) over blocks of whole
    groups and a last block that ends inside one gives build_pbwt_device's
    yz and aFend on the whole panel, with 1 written as another non-zero
    byte too."""
    X = rand_haps(M + sum(sizes), M, sum(sizes))
    bb = build.BlockBuild(M, device="cpu")
    s = 0
    for n in sizes:
        bb.add(np.ascontiguousarray(X[:, s:s + n].T) * np.uint8(one))
        s += n
    yz, a_end = bb.finish()
    want_yz, want_a, _ = build.build_pbwt_device(X, device="cpu")
    assert yz == want_yz and np.array_equal(a_end, want_a)
