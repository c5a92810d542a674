"""The output stage of reference imputation on the card (kernel K8) on the
CPU: its plain twins against the host's C pass (native.impute_emit) byte for
byte and the host's numpy sums (_vote_sums) bit for bit, at edge shapes; a
NumPy model of the chain block's steps (ring, gather, ballot scan, the
prefix array's one buffer) and one of the wide chain's (tiles, two passes,
the prefix array's two buffers) against the twin; the block's
configuration; and the arguments the wrappers hand the C entries."""

import numpy as np
import pytest
import torch

from pbwt_tpu_torch.algos import impute as port_impute
from pbwt_tpu_torch.core import native
from pbwt_tpu_torch.ops import impute as vote
from pbwt_tpu_torch.ops import kernels

torch.set_num_threads(1)

# dosages where the quantisation's rounding is closest to a level's edge
EDGES = [0.5, 0.05, 0.15, 0.25, 0.35, 0.45, 0.95, 0.85, 0.75, 0.65, 0.55,
         0.0000001, 0.9999999, 0.4999999, 0.5000001, 1e-300, 1.0 - 2 ** -53]


def vote_outputs(seed, T, Nref, none=(), every=(), flat=(), fraction=0.1,
                 edges=True):
    """K5-shaped results (dosage (T, Nref) f64, x, voted uint8): most
    dosages 0 or 1, a share `fraction` strictly between, with `edges` the
    level edges at random places; sites `none` with no vote (the site's
    frequency), sites `every` voted by all targets, sites `flat` with
    dosages 0 and 1 only."""
    rng = np.random.RandomState(seed)
    voted = rng.random_sample((T, Nref)) < 0.9
    voted[:, list(none)] = False
    voted[:, list(every)] = True
    kind = rng.random_sample((T, Nref))
    d = np.where(kind < 0.5 - fraction / 2, 0.0,
                 np.where(kind < 1 - fraction, 1.0,
                          rng.random_sample((T, Nref))))
    n_edge = min(T * Nref // 4, 4 * len(EDGES)) if edges else 0
    at = rng.choice(T * Nref, n_edge, replace=False)
    d.reshape(-1)[at] = np.resize(EDGES, n_edge)
    d[:, list(flat)] = np.round(d[:, list(flat)])
    freq = rng.random_sample(Nref)
    freq[:3] = (0.5, 0.25, 0.0)[:min(3, Nref)]
    d = np.where(voted, d, freq[None, :])
    return d, (d > 0.5).astype(np.uint8), voted.astype(np.uint8)


def card_stage(d, x, v):
    """The three twins as the imputer calls them on CPU tensors."""
    T = d.shape[0]
    sums, codes = vote.vote_sums(*(torch.from_numpy(a) for a in (d, x, v)))
    rows, a_end = vote.sort_codes(codes, T)
    yz, zd, off = vote.encode_rows(rows, T)
    return sums.numpy(), vote.download_emit(yz, zd, off, a_end)[:4]


def host_stage(d, x, v):
    T = d.shape[0]
    sums = port_impute._vote_sums(v.astype(bool), x, d)
    return sums, native.impute_emit(np.ascontiguousarray(x.T),
                                    np.ascontiguousarray(d.T),
                                    np.arange(T, dtype=np.int32))


def bits(a):
    return np.ascontiguousarray(a, np.float64).view(np.int64)


def assert_stage_equal(d, x, v):
    (sums, got), (want_sums, want) = card_stage(d, x, v), host_stage(d, x, v)
    assert got[0] == want[0] and got[1] == want[1]
    assert np.array_equal(got[2], want[2]) and got[2].dtype == np.int64
    assert np.array_equal(got[3], want[3]) and got[3].dtype == np.int32
    nvote, psum, xsum, pxsum = want_sums
    assert np.array_equal(sums[0], nvote)
    for g, w in zip(sums[1:], (psum, xsum, pxsum)):
        assert np.array_equal(bits(g), bits(w))
    return got


@pytest.mark.parametrize("T,Nref", [(1, 1), (1, 50), (2, 7), (31, 40),
                                    (37, 129), (200, 300), (2_000, 64),
                                    (0, 3), (3, 0)])
def test_twins_equal_the_host_pass(T, Nref):
    """yz, zDosage, dosageOffset and aFend are impute_emit's bytes; the four
    sums are _vote_sums' bits: T = 1, T not a multiple of 32 or 16, a site
    no target voted at, a site all targets voted at; no targets, no
    sites."""
    if not T or not Nref:
        d = np.zeros((T, Nref))
        assert_stage_equal(d, d.astype(np.uint8), d.astype(np.uint8))
        return
    d, x, v = vote_outputs(T * 1_000 + Nref, T, Nref, none=(0,),
                           every=(Nref - 1,), flat=(Nref // 2,))
    yz, zd, off, _ = assert_stage_equal(d, x, v)
    assert len(yz) >= Nref and len(zd) >= Nref and off[0] == 0


@pytest.mark.parametrize("T,frac", [(1_100, 0.0), (1_100, 0.3),
                                    (32_768, 0.0), (33_000, 0.0),
                                    (33_000, 0.001)])
def test_twins_long_zero_runs(T, frac):
    """Dosage zero runs past 2^10 and 2^15 (the escapes of 7 << 5, 0xFF)
    and runs of symbols past 31: all targets at dosages 0 or 1 save a share
    `frac`; 32,768 is the most the chain block holds in shared memory,
    33,000 goes to the wide chain."""
    d, x, v = vote_outputs(T + int(1e4 * frac), T, 3, every=(0, 1, 2),
                           fraction=frac, edges=False)
    d[:, 2] = np.where(np.arange(T) % 997 == 0, 0.35, d[:, 2])
    d[:T // 2, 0] = 0.3        # site 0 is in natural order: a run of symbol 3
    x = (d > 0.5).astype(np.uint8)
    _, zd, _, _ = assert_stage_equal(d, x, v)
    z = np.frombuffer(zd, np.uint8)
    assert (z == (3 << 5 | 31)).any()
    assert (z >> 5 == 7).any() == (frac < 0.1)
    assert (z == 0xFF).any() == (T >= 1 << 15 and frac == 0.0)


def test_twins_pack3_run_past_its_longest_code():
    """A pack3 run past 31 << 11 = 63,488 (bytes of 0x7f then the rest):
    64,000 targets, on the card the wide chain's."""
    T = 64_000
    d, x, v = vote_outputs(5, T, 2, every=(0, 1), fraction=0.0, edges=False)
    d[:, 0] = 0.0
    d[:, 1] = np.where(np.arange(T) < 63_600, 1.0, 0.0)
    x = (d > 0.5).astype(np.uint8)
    assert vote.emit_config(T, torch.device("cpu")) == (8, 1024, True)
    yz, _, _, _ = assert_stage_equal(d, x, v)
    assert yz.count(0x7F) == 1 and yz.count(0xFF) == 1


def test_dosage_symbols_equal_the_codec():
    """The twin's symbols are dosage_encode's, edges included."""
    d = np.concatenate((EDGES, np.random.RandomState(3).random_sample(500)))
    got = vote.dosage_symbols(torch.from_numpy(d)).numpy()
    assert np.array_equal(got, port_impute.dosage_encode(d))


@pytest.mark.parametrize("T", [1, 15, 16, 37, 250, 257, 2_000, 2_049,
                               8_193, 20_000, 32_768])
def test_chain_config(T):
    """The chain block holds every position (threads x positions >= T, a
    warp's multiple, at most 1,024 threads) with a ring of 2 rows and the
    prefix array in the H100's 232,448 shared bytes, up to 32,768 targets;
    past them, or past a smaller block's shared bytes, the wide chain."""
    per, threads, wide = vote.chain_config(T)
    pitch = vote.code_pitch(T)
    assert not wide and vote.CHAIN_SLOTS == 2
    assert per in vote.CHAIN_PER and threads % 32 == 0
    assert per * threads >= T and per * (threads - 32) < T
    assert threads <= 1024
    assert vote.CHAIN_FIXED + 4 * pitch <= 232_448
    # the fewest positions a thread that keep the block within CHAIN_WIDE
    assert threads <= vote.CHAIN_WIDE or per == vote.CHAIN_PER[-1]
    assert per == vote.CHAIN_PER[0] or -(-T // (per // 2)) > vote.CHAIN_WIDE
    wide_threads = min(1024, -(-T // 256) * 32)
    assert vote.chain_config(T, smem=vote.CHAIN_FIXED + 3 * pitch) == \
        (8, wide_threads, True)
    assert vote.chain_config(0) is None
    assert vote.chain_config(T + 32_768) == (8, 1024, True)


def ballot_scan(c, per):
    """The warps' scan of the threads' counts `c` (at most `per` each): a
    ballot a bit of the count, popc below the lane; then the warps' totals
    in order. Returns (each thread's zeros before it, the block's total)."""
    threads = len(c)
    warp = np.arange(threads) // 32
    before = np.zeros(threads, np.int64)
    tot = np.zeros(threads // 32, np.int64)
    for b in range(per.bit_length()):
        bit = (c >> b) & 1
        for w in range(threads // 32):
            m = bit[warp == w]
            before[warp == w] += (np.cumsum(m) - m) << b
            tot[w] += m.sum() << b
    return before + np.array([tot[:w].sum() for w in warp]), tot.sum()


def chain_model(codes, T, per, threads, slots=2):
    """k8_chain's steps in NumPy: a ring of `slots` rows filled ahead (the
    row `slots` sites on goes into a slot once its site's first barrier has
    passed), a thread's `per` consecutive positions gathered through a,
    a ballot a bit of each thread's count of zeros for the warp's scan, the
    warps' totals read back in order, and the partition written into a's
    one buffer after every read of it."""
    Nref, pitch = codes.shape
    ring = np.zeros((slots, pitch), np.uint8)
    held = np.full(slots, -1)
    for r in range(min(slots, Nref)):
        ring[r], held[r] = codes[r], r
    a = np.zeros(pitch, np.int64)
    a[:T] = np.arange(T)
    out = np.zeros_like(codes)
    pos = (np.arange(threads)[:, None] * per + np.arange(per)[None, :])
    inside = pos < T
    for k in range(Nref):
        slot = k % slots
        assert held[slot] == k                     # the slot's barrier phase
        av = np.where(inside, a[np.minimum(pos, pitch - 1)], 0)
        y = np.where(inside, ring[slot][av], 0)
        keep = pos < pitch
        out[k, pos[keep]] = y[keep]
        zeros = inside & ((y & 8) == 0)
        before, nzero = ballot_scan(zeros.sum(1), per)
        # the first barrier: every read of a and of the row is done
        if k + slots < Nref:
            ring[slot], held[slot] = codes[k + slots], k + slots
        zb = before[:, None] + np.cumsum(zeros, 1) - zeros
        dest = np.where(zeros, zb, nzero + pos - zb)
        assert np.array_equal(np.sort(dest[inside]), np.arange(T))
        a[dest[inside]] = av[inside]
    return out, a[:T]


@pytest.mark.parametrize("T,Nref", [(1, 5), (37, 40), (200, 33), (2_000, 20),
                                    (5_000, 9), (20_000, 3)])
def test_chain_model_equals_twin(T, Nref):
    """The block's steps, at its configuration for T, give the twin's sorted
    rows and last prefix array."""
    per, threads, _ = vote.chain_config(T)
    d, x, v = vote_outputs(T + Nref, T, Nref, every=(0,))
    _, codes = vote.vote_sums_plain(*(torch.from_numpy(a) for a in (d, x, v)))
    want, a_end = vote.sort_codes_plain(codes, T)
    got, a_model = chain_model(codes.numpy(), T, per, threads)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(a_model, a_end.numpy())
    assert np.array_equal(got[:, T:], np.zeros_like(got[:, T:]))


def wide_chain_model(codes, T, threads, per=8):
    """k8_chain_wide's steps in NumPy: the prefix array's two buffers of a
    pitch each, a site reading one and writing the other; a first pass over
    tiles of threads x per positions (a thread's `per` consecutive ones)
    that gathers the row through a, stores the sorted row (the pitch's
    padding too) and counts the zeros; a second that reads each tile's codes
    back, scans the zeros by ballots and writes the partition, the earlier
    tiles' zeros carried."""
    Nref, pitch = codes.shape
    buf = np.full((2, pitch), -1, np.int64)       # past T: never read
    buf[0, :T] = np.arange(T)
    out = np.zeros_like(codes)
    tile = threads * per
    for k in range(Nref):
        cur, nxt = buf[k & 1], buf[(k & 1) ^ 1]
        nzero = 0
        for t0 in range(0, pitch, tile):
            pos = t0 + np.arange(threads)[:, None] * per + np.arange(per)
            keep, inside = pos < pitch, pos < T
            y = np.where(inside, codes[k][np.where(inside, cur[np.minimum(
                pos, pitch - 1)], 0)], 0)
            out[k, pos[keep]] = y[keep]
            nzero += (inside & ((y & 8) == 0)).sum()
        run = 0
        for t0 in range(0, T, tile):
            pos = t0 + np.arange(threads)[:, None] * per + np.arange(per)
            inside = pos < T
            y = np.where(inside, out[k][np.minimum(pos, pitch - 1)], 0)
            zeros = inside & ((y & 8) == 0)
            before, total = ballot_scan(zeros.sum(1), per)
            zb = run + before[:, None] + np.cumsum(zeros, 1) - zeros
            dest = np.where(zeros, zb, nzero + pos - zb)
            nxt[dest[inside]] = cur[pos[inside]]
            run += total
        assert run == nzero
    return out, buf[Nref & 1, :T]


@pytest.mark.parametrize("T,Nref,threads", [(1, 5, 32), (37, 40, 32),
                                            (2_000, 20, 32), (2_000, 7, 256),
                                            (5_000, 9, 64), (33_000, 3, 1024),
                                            (70_000, 2, 1024)])
def test_wide_chain_model_equals_twin(T, Nref, threads):
    """The wide chain's steps, in one tile or many (T = 70,000 past the
    uint16 prefix array's reach), give the twin's sorted rows, their
    padding 0, and last prefix array."""
    d, x, v = vote_outputs(T + Nref, T, Nref, every=(0,))
    _, codes = vote.vote_sums_plain(*(torch.from_numpy(a) for a in (d, x, v)))
    want, a_end = vote.sort_codes_plain(codes, T)
    got, a_model = wide_chain_model(codes.numpy(), T, threads)
    assert np.array_equal(got, want.numpy())
    assert np.array_equal(a_model, a_end.numpy())


def k8_arguments(monkeypatch, wide):
    """The arguments each wrapper hands its C entry are as many as the
    entry's ctypes signature types, its ints where it has ints: tensors on
    the meta device, the launches recorded. The chain's prefix buffer is
    null in the shared block and given to the wide chain (here past a
    patched CHAIN_SHARED_TARGETS)."""
    T, Nref = 37, 50
    dev = torch.device("meta")
    calls = []
    if wide:
        monkeypatch.setattr(vote, "CHAIN_SHARED_TARGETS", T - 1)
    monkeypatch.setattr(kernels, "typed_cuda_tensors", lambda *p: dev)
    monkeypatch.setattr(kernels, "stream", lambda d: 0)
    monkeypatch.setattr(kernels, "launch", lambda n, *a: calls.append((n, a)))
    meta = dict(device="meta")
    vote.vote_sums(torch.empty((T, Nref), dtype=torch.float64, **meta),
                   *(torch.empty((T, Nref), dtype=torch.uint8, **meta),) * 2)
    codes = torch.empty((Nref, vote.code_pitch(T)), dtype=torch.uint8, **meta)
    vote.sort_codes(codes, T)
    with pytest.raises(NotImplementedError):       # the totals' download
        vote.encode_rows(codes, T)
    per, threads, is_wide = vote.chain_config(T)
    assert is_wide == wide
    # the device's index first: None for the meta device, a card's number
    want_ints = {"k8_sums": [None, T, Nref, 48],
                 "k8_chain": [None, T, Nref, 48, per, threads],
                 "k8_encode": [None, T, Nref, 48]}
    assert [n for n, _ in calls] == ["k8_sums", "k8_chain", "k8_encode"]
    for name, args in calls:
        sig = kernels._SIGNATURES[name]
        assert len(args) == len(sig)
        ints = [i for i, t in enumerate(sig) if t is kernels._I]
        assert [args[i] for i in ints] == want_ints[name]
    assert (calls[1][1][7] is None) == (not wide)   # the prefix buffer
    assert calls[2][1][6:9] == (None, None, None)  # the counting pass


def test_k8_arguments_match_the_entry_signatures(monkeypatch):
    k8_arguments(monkeypatch, wide=False)


def test_k8_wide_chain_arguments_match_the_entry_signature(monkeypatch):
    k8_arguments(monkeypatch, wide=True)
