"""Painting's within-panel match collection as the card makes it
(``ops/paint.collect_matches``), on CPU tensors through the kernels' plain
twins, held against the JAX package (``pbwt_tpu``) on the same inputs, its
pack3 bytes built by the JAX package's C pass: ``k1_decode_columns``'
(``build.decode_columns_plain``) against its ``decode_cols``, K2's
``k2_partition_ad_table``'s (``partition.ad_table_plain``) against its
engine's algorithm 2 site by site, and K9's counting and filling passes
(``paint.max_within_count_plain``, ``max_within_fill_plain``) with the
chunking around them against its ``max_within_bucketed``: (sj, ss, se,
seg_off) element for element and in order, as the port's own host C pass
gives them too. And the device route of -paint on a CPU device, which
keeps the host C pass: its tables and files."""

import io

import numpy as np
import pytest
import torch

import pbwt_tpu.core.engine as jax_engine
import pbwt_tpu.core.native as jax_native
import pbwt_tpu_torch.algos.paint as port_paint
import pbwt_tpu_torch.core.pbwt as port_pbwt
import pbwt_tpu_torch.core.registry as port_registry
import pbwt_tpu_torch.utils as port_utils
from pbwt_tpu_torch import tracing
from pbwt_tpu_torch.core import native
from pbwt_tpu_torch.ops import build, partition
from pbwt_tpu_torch.ops import paint as device_paint

torch.set_num_threads(1)

TABLES = ("chunkcounts.out", "chunklengths.out",
          "regionsquaredchunkcounts.out", "regionchunkcounts.out")


@pytest.fixture(autouse=True)
def host_routes(monkeypatch):
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "0")
    port_registry.init()
    port_utils.set_log_file(io.StringIO())


def mosaic(seed, M, N, founders=6, switch=0.03, noise=0.0):
    """Each haplotype a walk over a few founders, with allele noise."""
    rng = np.random.RandomState(seed)
    F = (rng.random_sample((founders, N)) < 0.4).astype(np.uint8)
    src = rng.randint(founders, size=M)
    X = np.empty((M, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(M) < switch
        src[sw] = rng.randint(founders, size=int(sw.sum()))
        X[:, k] = F[src, k]
    X ^= (rng.random_sample((M, N)) < noise).astype(np.uint8)
    return X


def complements(seed, N):
    """Two haplotypes that differ at every site: their match ends where it
    starts, at every site (zero-length matches)."""
    h = mosaic(seed, 1, N)
    return np.concatenate([h, 1 - h])


def identical_runs(seed, M, N):
    """Runs of identical haplotypes: a few haplotypes, each repeated."""
    return np.repeat(mosaic(seed, -(-M // 7), N, 3, 0.05), 7, 0)[:M]


def pack3(X, a0):
    """The pack3 bytes of X's sorted columns, the prefix array starting at
    a0 (the JAX package's C build)."""
    return jax_native.build_pbwt(np.ascontiguousarray(X.T), a0)[0]


def reference_segments(yz, M, N, a0):
    """The JAX package's (sj, ss, se, seg_off) of the panel, which the
    port's host C pass gives too."""
    want = [np.asarray(w) for w in jax_native.max_within_bucketed(
        yz, M, N, a0)]
    for w, h in zip(want, native.max_within_bucketed(yz, M, N, a0)):
        np.testing.assert_array_equal(np.asarray(h), w)
    return want


def start(M, permuted):
    return (np.random.RandomState(M).permutation(M).astype(np.int32)
            if permuted else np.arange(M, dtype=np.int32))


def z(yz: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(yz), dtype=torch.uint8) if yz else (
        torch.empty(0, dtype=torch.uint8))


def unpacked(ycols, M):
    return build.unpack_columns(ycols.numpy(), M)


# (name, panel, permuted start, chunk budget in sites or None)
PANELS = [
    ("odd_M", lambda: mosaic(1, 37, 120), False, None),
    ("N1", lambda: mosaic(2, 45, 1), False, None),
    ("identical_runs", lambda: identical_runs(3, 61, 90), False, None),
    ("aFstart", lambda: mosaic(4, 50, 80, noise=0.01), True, None),
    ("M2", lambda: mosaic(5, 2, 40, 2, 0.1), False, None),
    ("chunks_of_7", lambda: mosaic(6, 40, 60, noise=0.01), False, 7),
    ("chunks_of_1", lambda: mosaic(7, 33, 20), True, 1),
    ("chunk_ends_at_N", lambda: mosaic(8, 35, 30), False, 10),
    ("zero_length", lambda: complements(14, 50), False, None),
]


@pytest.mark.parametrize("name,make,permuted,chunk", PANELS,
                         ids=[p[0] for p in PANELS])
def test_collect_matches_equals_host_c(monkeypatch, name, make, permuted,
                                       chunk):
    """The decode, trajectory and both K9 passes (the twins), in chunks of
    sites where a budget is set, give the JAX package's segments exactly
    (and so the port's host C pass's): zero-length matches and the flush at
    k = N included. A start of None is the identity."""
    X = make()
    M, N = X.shape
    a0 = start(M, permuted)
    yz = pack3(X, a0)
    if chunk:
        monkeypatch.setattr(device_paint, "COLLECT_BYTES", 12 * M * chunk)
    want = reference_segments(yz, M, N, a0)
    got = device_paint.collect_matches(yz, M, N,
                                       a0 if permuted else None, "cpu")
    for w, g in zip(want, got):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w)
    sj, ss, se, off = want
    assert len(sj) and (se == N).any()          # the flush reports
    if name == "zero_length":
        assert (ss == se).any()                 # zero-length matches kept


@pytest.mark.parametrize("M,N,permuted", [(37, 120, False), (4_500, 3, True),
                                          (64, 1, False), (33, 50, True)])
def test_decode_columns_plain_matches_host(M, N, permuted):
    """The twin of k1_decode_columns against the JAX package's and the
    port's p3_decode_cols: M not a multiple of 32, runs of every pack3 tier
    (4,500 identical rows), N = 1; and decoding undoes the card's encoder
    (encode_columns_plain)."""
    X = (identical_runs(M, M, N) if M > 1000 else
         mosaic(M, M, N, noise=0.02))
    yz = pack3(X, start(M, permuted))
    ycols = build.decode_columns(z(yz), N, M)
    assert ycols.shape == (N, -(-M // 32)) and ycols.dtype == torch.int32
    want = jax_native.decode_cols(yz, N, M)
    np.testing.assert_array_equal(native.decode_cols(yz, N, M), want)
    np.testing.assert_array_equal(unpacked(ycols, M), want)
    assert bytes(build.encode_columns_plain(ycols, M).numpy()) == yz
    # rows past M are 0
    assert not (unpacked(ycols, ycols.shape[1] * 32)[:, M:]).any()


def test_decode_columns_reads_only_its_sites():
    """Bytes past the N sites' rows are not read, as p3_decode_cols stops
    after N sites; fewer sites decode to the first rows."""
    X = mosaic(9, 40, 30)
    yz = pack3(X, start(40, False))
    want = jax_native.decode_cols(yz, 12, 40)
    for extra in (b"", b"\xff\x00\x13"):
        got = build.decode_columns(z(yz + extra), 12, 40)
        np.testing.assert_array_equal(unpacked(got, 40), want)


@pytest.mark.parametrize("fault", ["truncated", "across_a_site", "empty",
                                   "too_few_sites"])
def test_decode_columns_raises_on_a_malformed_stream(fault):
    """Where p3_decode_cols returns -1 (the JAX package's and the port's
    raise), decode_columns raises ValueError."""
    M, N = 40, 30
    yz = pack3(mosaic(10, M, N), start(M, False))
    bad = {"truncated": yz[:-1],
           "across_a_site": bytes([0x80 | (M + 1)]) + yz[1:],
           "empty": b"",
           "too_few_sites": yz}[fault]
    n = N + 1 if fault == "too_few_sites" else N
    for host in (jax_native, native):
        with pytest.raises(ValueError):
            host.decode_cols(bad, n, M)
    with pytest.raises(ValueError, match="pack3"):
        build.decode_columns(z(bad), n, M)


@pytest.mark.parametrize("M,N,first", [(37, 70, 0), (64, 33, 5), (2, 9, 0)])
def test_ad_table_plain_matches_host_engine(M, N, first):
    """Row r of the twin's tables is the JAX package's host engine's (a, d)
    before site first + r (algorithm 2 from a carried state), d without its
    d[M] sentinel; row 0 is the caller's."""
    X = mosaic(M, M, N, noise=0.01)
    a0 = start(M, True)
    yz = pack3(X, a0)
    ycols = build.decode_columns(z(yz), N, M)
    Y = jax_native.decode_cols(yz, N, M)
    a, d = a0.copy(), np.zeros(M + 1, np.int32)
    d[0] = d[M] = first + 1
    A = torch.empty((N + 1, M), dtype=torch.int32)
    D = torch.empty_like(A)
    A[0], D[0] = torch.from_numpy(a), torch.from_numpy(d[:M])
    partition.ad_table(ycols, A, D, first)
    for r in range(N + 1):
        np.testing.assert_array_equal(A[r].numpy(), a)
        np.testing.assert_array_equal(D[r].numpy(), d[:M])
        if r < N:
            a, d = jax_engine.forwards_ad(a, d, Y[r], first + r)


def test_k9_passes_on_part_of_the_sites():
    """K9's twins over sites k0.. of a panel from the tables' rows there:
    each (site, recipient)'s count is what the JAX package's whole call
    reports there, and the filling pass writes them in (recipient, site)
    order."""
    M, N, k0 = 30, 40, 17
    X = mosaic(11, M, N, noise=0.01)
    a0 = start(M, False)
    yz = pack3(X, a0)
    ycols = build.decode_columns(z(yz), N, M)
    A = torch.empty((N + 1, M), dtype=torch.int32)
    D = torch.empty_like(A)
    A[0], D[0] = torch.from_numpy(a0), 0
    partition.ad_table(ycols, A, D, 0)
    sj, ss, se, off = reference_segments(yz, M, N, a0)
    nk = N + 1 - k0
    counts = torch.empty((M, nk), dtype=torch.int32)
    device_paint.max_within_count(A[k0:], D[k0:], ycols[k0:], k0, N, counts)
    rec = np.repeat(np.arange(M), np.diff(off))
    for r in range(nk):
        np.testing.assert_array_equal(
            counts[:, r].numpy(), np.bincount(rec[se == k0 + r], minlength=M))
    tot = counts.sum(1, dtype=torch.int64)
    counts.cumsum_(1)
    base = torch.cumsum(tot, 0) - tot
    seg = [torch.empty(int(tot.sum()), dtype=torch.int32) for _ in range(3)]
    device_paint.max_within_fill(A[k0:], D[k0:], ycols[k0:], k0, N, counts,
                                 base, *seg)
    keep = se >= k0
    for g, w in zip(seg, (sj, ss, se)):
        np.testing.assert_array_equal(g.numpy(), w[keep])


def test_collection_scratch_keeps_the_dense_site_limit():
    """The collection's scratch is bounded by COLLECT_BYTES in chunks of
    sites, and stays below K6's own at 5,008 haplotypes from the cell's
    16,384 sites to the dense route's 500,000: the route's peak and its
    limit of sites are K6's, as before."""
    M, ploidy, nseg = 5_008, 2, 10_400_000
    for N in (16_384, 500_000):
        nz = 362 * N                        # the cell's bytes a site
        k6 = (device_paint.device_bytes(M, N, ploidy, nseg)
              - device_paint.segment_bytes(M, nseg))
        assert device_paint.collect_bytes(M, N, nz) < k6
    # the cell's shape is one chunk: A + D + the counts of 16,385 sites
    assert device_paint._chunk_sites(M) > 16_384


def test_device_route_on_cpu_keeps_the_host_pass(tmp_path, monkeypatch):
    """-paint's device route on a CPU device collects by the host C pass
    (no card collection is counted): its tables are K6's twin's on the host
    C pass's segments, uploaded, to the bit, its files the host route's;
    the card collection's segments, handed to paint_tables_device as
    tensors (no upload), give the same tables to the bit."""
    X = mosaic(12, 24, 90, noise=0.01)
    p = port_pbwt.PBWT.from_haplotypes(X)
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "0")
    port_paint.paint_ancestry_matrix(p, str(tmp_path / "host"), 4, 2)
    before = tracing.counters().get("ops.paint.card_collects", 0)
    monkeypatch.setenv("PBWT_TORCH_DEVICE", "cpu")
    dev = port_paint.paint_ancestry_matrix(p, str(tmp_path / "dev"), 4, 2)
    assert tracing.counters().get("ops.paint.card_collects", 0) == before
    for t in TABLES:
        assert (open(f"{tmp_path}/dev.{t}").read()
                == open(f"{tmp_path}/host.{t}").read())
    from_host = device_paint.paint_tables_device(
        *port_paint._collect_match_arrays(p), p.M, p.N, 2, 4, device="cpu")
    a0 = np.arange(p.M, dtype=np.int32)
    segs = device_paint.collect_matches(p.yz, p.M, p.N, a0, "cpu")
    uploads = tracing.totals().get("ops.paint.upload")
    on_dev = device_paint.paint_tables_device(*segs, p.M, p.N, 2, 4,
                                              device="cpu")
    assert tracing.totals().get("ops.paint.upload") == uploads
    for g, d, w in zip(on_dev, dev, from_host):
        assert np.array_equal(g.view(np.int64), w.view(np.int64))
        # dev's chunk lengths were normalised in place by the printer
        assert d.shape == w.shape


def test_card_route_collects_on_the_card(monkeypatch):
    """On a CUDA device the route hands the panel's pack3 bytes and aFstart
    to collect_matches, counts the request in ops.paint.card_collects and
    the segments in ops.paint.segments, and K6 gets the JAX package's
    segments (the card's calls stood in for by the twins on the CPU)."""
    X = mosaic(13, 20, 60, noise=0.01)
    a0 = start(20, True)
    p = port_pbwt.PBWT(20, 60)
    p.yz, p.aFstart = pack3(X, a0), a0
    seen = []
    real_collect = device_paint.collect_matches
    real_tables = device_paint.paint_tables_device

    def collect(yz, M, N, start, device):
        seen.append((yz, M, N, np.array(start), torch.device(device).type))
        return real_collect(yz, M, N, start, "cpu")
    monkeypatch.setattr(device_paint, "collect_matches", collect)
    monkeypatch.setattr(device_paint, "paint_tables_device",
                        lambda *a, device=None: real_tables(*a, device="cpu"))
    counts = tracing.counters()
    got = port_paint._paint_device(p, 5, 2, device="cuda")
    after = tracing.counters()
    assert len(seen) == 1 and seen[0][:3] == (p.yz, 20, 60)
    np.testing.assert_array_equal(seen[0][3], a0)
    assert seen[0][4] == "cuda"
    assert (after["ops.paint.card_collects"]
            == counts.get("ops.paint.card_collects", 0) + 1)
    host = reference_segments(p.yz, 20, 60, a0)
    assert (after["ops.paint.segments"]
            == counts.get("ops.paint.segments", 0) + len(host[0]))
    want = real_tables(*host, 20, 60, 2, 5, device="cpu")
    for g, w in zip(got, want):
        assert np.array_equal(g.view(np.int64), w.view(np.int64))
