"""The port's reference imputation on the CPU against the JAX package's:
the plain twin of kernel K5, called as ReferenceImputer calls it, against
impute_jax.impute_dosages_device (alleles and quantised dosages) and against
the port's host routes (dosages bit for bit), and reference_impute3 as a
whole on all three of the port's routes against pbwt_tpu.algos.impute's."""

import io

import numpy as np
import pytest
import torch

import pbwt_tpu.algos.impute as ref_impute
import pbwt_tpu.core.native as ref_native
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


def device_vote(segments, T, Xref, kold, ref_freq):
    """The vote as ReferenceImputer.impute takes it, on CPU tensors:
    segment_columns, impute_vote (K5's plain twin here) and download;
    Xref (Mref, Nref) uint8 as numpy or a tensor. Returns (x, dosage,
    voted) as numpy arrays."""
    cols = port_device.segment_columns(np.asarray(segments), T)
    off, jref, s, e = (torch.from_numpy(c) for c in cols)
    if not torch.is_tensor(Xref):
        Xref = torch.from_numpy(np.ascontiguousarray(Xref, np.uint8))
    kold = torch.from_numpy(np.asarray(kold, np.int32))
    freq = torch.from_numpy(np.asarray(ref_freq, np.float64))
    return port_device.download(*port_device.impute_vote(
        off, jref, s, e, Xref, kold, freq))


@pytest.mark.parametrize("Mref,N", [(255, 130), (256, 700), (1023, 130),
                                    (1024, 513)])
def test_vote_twin_matches_jax_and_host(Mref, N):
    """K5's plain twin, as ReferenceImputer calls it on CPU tensors, against
    the JAX package's device pass (x equal, dosage_encode bytes equal: its
    f32 sums are only close) and against the port's numpy host vote (dosage
    equal bit for bit), with a target that has no match and Nref not a
    multiple of 512."""
    T = 9
    Xref, Xq, frame_idx = problem(Mref + N, Mref, T, N)
    segments, kold, ref_freq = vote_inputs(Xref, Xq, frame_idx, drop=4)
    assert len(segments) > T and N % 512
    before = dict(kernels.LAUNCHES)
    x, dosage, voted = device_vote(segments, T, Xref, kold, ref_freq)
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
    x, dosage, voted = device_vote(none, 1, reference, kold, freq)
    assert not voted.any() and np.array_equal(bits(dosage[0]), bits(freq))
    assert np.array_equal(x[0], freq > 0.5)
    # [start, end) = [5, 6): (k - 5)(6 - k) is never positive at an integer k
    thin = np.array([[0, 3, 5, 6], [0, 7, 2, 9]], np.int64)
    x, dosage, voted = device_vote(thin, 1, Xref, kold, freq)
    inside = (kold > 2) & (kold < 9)
    assert np.array_equal(voted[0], inside)
    assert np.array_equal(dosage[0][inside], Xref[7][inside].astype(float))


def edge_segments(seed, T=5, N=700, heavy=60):
    """Vote inputs at the edges of K5's design, as numpy arrays: a frame
    coordinate a site that repeats and jumps; random segments (some end
    before an earlier one); `heavy` segments that all weigh in chunk 1;
    target 2 without segments; target 3 with one segment over every site;
    target 4 with ends equal to a span's least coordinate.
    Returns (off, jref, start, end, Xref, kold, ref_freq) sorted by (target,
    start)."""
    rng = np.random.RandomState(seed)
    kold = np.cumsum(rng.choice([0, 0, 1, 1, 2, 9, 40], size=N))
    frame = int(kold[-1]) + 1
    lo, hi = int(kold[256]), int(kold[511])
    s = rng.randint(0, frame, size=80)
    e = s + rng.randint(1, frame // 3, size=80)
    tg = rng.choice([0, 1, 3, 4], size=80)
    # target 4 starts with two segments that end exactly at the least
    # coordinate of a span of 1 or 2 chunks, where its first segment turns
    s = np.concatenate([s, lo - rng.randint(1, 4, size=heavy), [0], [0, 0]])
    e = np.concatenate([e, hi + rng.randint(1, 4, size=heavy), [frame],
                        kold[[256, 512]]])
    tg = np.concatenate([tg, np.ones(heavy, int), [3], [4, 4]])
    order = np.lexsort((s, tg))
    off = np.zeros(T + 1, np.int64)
    np.cumsum(np.bincount(tg, minlength=T), out=off[1:])
    Xref = (rng.random_sample((30, N)) < 0.4).astype(np.uint8)
    return (off, rng.randint(0, 30, size=len(tg)).astype(np.int32),
            s[order].astype(np.int32), e[order].astype(np.int32), Xref,
            kold.astype(np.int32), rng.random_sample(N))


def vote_in_order(off, jref, s, e, Xref, kold, freq):
    """The vote of the host's loop: each (target, site) adds its covering
    segments in segment order, in f64."""
    T, N = len(off) - 1, Xref.shape[1]
    dosage = np.empty((T, N))
    for t, k in np.ndindex(T, N):
        ko, ssum, score = int(kold[k]), 0.0, 0.0
        for i in range(off[t], off[t + 1]):
            w = float(ko - int(s[i])) * float(int(e[i]) - ko)
            if s[i] < ko and w > 0.0:
                ssum += w
                if Xref[jref[i], k]:
                    score += w
        dosage[t, k] = freq[k] if ssum == 0.0 else score / ssum
    return dosage


def wide_segments(seed, N=300):
    """Segments whose weights leave K5's integer regime: target 0 starts in
    it (short segments) and leaves it in a later slice (ends near 2^30);
    target 1 has sums past 2^53 (starts near -2^30), where the order of the
    f64 additions shows."""
    rng = np.random.RandomState(seed)
    kold = np.arange(N, dtype=np.int32)
    s0 = np.sort(rng.randint(0, 100, size=9))
    e0 = np.where(np.arange(9) < 6, s0 + rng.randint(2, 40, size=9),
                  (1 << 30) - rng.randint(0, 1000, size=9))
    s1 = np.sort(-(1 << 30) + rng.randint(0, 1 << 20, size=12))
    e1 = (1 << 30) - rng.randint(0, 1 << 20, size=12)
    s, e = (np.concatenate(a).astype(np.int32) for a in ((s0, s1), (e0, e1)))
    Xref = (rng.random_sample((10, N)) < 0.5).astype(np.uint8)
    return (np.array([0, 9, 21], np.int64),
            rng.randint(0, 10, size=21).astype(np.int32), s, e, Xref, kold,
            rng.random_sample(N))


def window_loop(off, e, kold, span):
    """vote_window's (emax, first) by a plain loop."""
    T, C = len(off) - 1, port_device.CHUNK
    emax = np.empty(len(e), np.int64)
    for t in range(T):
        top = None
        for i in range(off[t], off[t + 1]):
            top = e[i] if top is None else max(top, e[i])
            emax[i] = top
    sites = span * C
    first = np.empty((-(-len(kold) // sites), T), np.int64)
    for p in range(first.shape[0]):
        least = kold[p * sites:(p + 1) * sites].min()
        for t in range(T):
            i = off[t]
            while i < off[t + 1] and emax[i] <= least:
                i += 1
            first[p, t] = i
    return emax, first


@pytest.mark.parametrize("span", [1, 2, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_vote_window_matches_a_loop(seed, span):
    """K5's preparation (each segment's running maximum of ends within its
    target, each (span, target)'s first segment) against a plain loop, with
    a target without segments, segments that end before an earlier one and
    a frame coordinate that repeats and jumps; and span_chunks from Mref."""
    off, _, _, e, _, kold, _ = edge_segments(seed)
    assert off[3] == off[2] and (np.diff(e[off[0]:off[1]]) < 0).any()
    emax, first = port_device.vote_window(
        *(torch.from_numpy(a) for a in (off, e, kold)), span)
    want_emax, want_first = window_loop(off, e, kold, span)
    assert emax.dtype == torch.int32 and first.dtype == torch.int64
    assert np.array_equal(emax.numpy(), want_emax)
    assert np.array_equal(first.numpy(), want_first)
    assert [port_device.span_chunks(m) for m in (1, 20_000, 10**7)] == [
        port_device.SPAN_MAX, 8, 1]


EXACT_U32 = 4.0e9     # K5's integer regime: sums below 2^32 (impute_vote.cu)


def k5_model(off, jref, s, e, Xref, kold, freq, span, rows):
    """K5's blocks as csrc/impute_vote.cu walks them, in Python numbers (the
    same f64 roundings): a block a (span, target) from vote_window's first
    segment; per chunk a run of 32 segments a step, packed into slices of
    `rows` while the starts stay below the chunk's largest coordinate and
    kept where the end passes its least; the next chunk's scan from the
    first segment whose running maximum of ends passes the least coordinate
    still to come; every site summing its slices in order, as unsigned
    32-bit integers while the slices' bounds allow, then in f64."""
    big = 2**31 - 1
    emax, first = (a.numpy() for a in port_device.vote_window(
        *(torch.from_numpy(a) for a in (off, e, kold)), span))
    T, N, C = len(off) - 1, Xref.shape[1], port_device.CHUNK
    sp, ep, emp = (np.append(a, 0) for a in (s, e, emax))
    dosage = np.empty((T, N))
    voted = np.zeros((T, N), bool)
    for p, t in np.ndindex(first.shape):
        c0 = p * span
        nch = min(span, -(-N // C) - c0)
        ks = [kold[(c0 + c) * C:(c0 + c + 1) * C] for c in range(nch)]
        clo, chi = [int(k.min()) for k in ks], [int(k.max()) for k in ks]
        lsuf = [min(clo[c:]) for c in range(nch)] + [big]
        end = off[t + 1]

        def pack(pos, lo, hi, lnext, find_next):
            start, kept, nxt = pos, [], -1
            while True:
                idx = np.arange(pos, pos + 32)
                valid = idx < end
                at = np.minimum(idx, len(s))
                stop = ~valid | (sp[at] >= hi)
                lim = int(np.argmax(stop)) if stop.any() else 32
                if find_next and nxt < 0:
                    past = (valid & (emp[at] > lnext)) | stop
                    if past.any():
                        nxt = pos + int(np.argmax(past))
                keep = [pos + i for i in range(lim) if ep[at[i]] > lo]
                room = rows - len(kept)
                if len(keep) > room:
                    kept += keep[:room]
                    return kept, keep[room], (nxt if nxt >= 0 else
                                              keep[room])
                kept += keep
                if stop.any():
                    return kept, None, (nxt if nxt >= 0 else start)
                pos += 32

        def bound(sl, lo, hi):
            if not sl:
                return 0.0
            reach = max(int(e[i]) - lo for i in sl)
            return float(len(sl)) * float(hi - int(s[sl[0]])) * float(reach)

        scan = first[p, t]
        for c in range(nch):
            kept, resume, scan = pack(scan, clo[c], chi[c], lsuf[c + 1], True)
            slices = [kept]
            while resume is not None:
                kept, resume, _ = pack(resume, clo[c], chi[c], big, False)
                slices.append(kept)
            assert all(len(sl) <= rows for sl in slices)
            exact, cb = [], 0.0
            for sl in slices:
                cb += bound(sl, clo[c], chi[c])
                exact.append(cb < EXACT_U32)
            for k in range((c0 + c) * C, min((c0 + c + 1) * C, N)):
                ko, isum, iscore = int(kold[k]), 0, 0
                ssum = score = None
                for sl, fits in zip(slices, exact):
                    if fits:
                        for i in sl:
                            w = max(ko - int(s[i]), 0) * max(int(e[i]) - ko, 0)
                            isum += w
                            iscore += w * int(Xref[jref[i], k])
                        assert isum < 2**32
                        continue
                    if ssum is None:
                        ssum, score = float(isum), float(iscore)
                    for i in sl:
                        if s[i] >= ko:
                            continue
                        w = float(ko - int(s[i])) * float(int(e[i]) - ko)
                        if w > 0.0:
                            ssum += w
                            if Xref[jref[i], k]:
                                score += w
                if ssum is None:
                    ssum, score = float(isum), float(iscore)
                dosage[t, k] = freq[k] if ssum == 0.0 else score / ssum
                voted[t, k] = ssum != 0.0
    return dosage, (dosage > 0.5).astype(np.uint8), voted


@pytest.mark.parametrize("span,rows", [(1, 32), (2, 32), (2, 3), (32, 5)])
def test_k5_design_matches_twin_bit_for_bit(span, rows):
    """K5's walk as designed (k5_model: the carried run of segments, slices
    of a slot, a chunk with more segments than a slot, the integer regime
    and its way out) against the twin bit for bit, on the design's edge
    cases and on the matches of a real imputation problem; and against the
    host's order of f64 additions where weights pass 2^32 and sums 2^53."""
    problems = [edge_segments(2 + span)]
    Xref, Xq, frame_idx = problem(7, 200, 6, 600)
    segments, kold, ref_freq = vote_inputs(Xref, Xq, frame_idx, drop=2)
    cols = port_device.segment_columns(segments, 6)
    problems.append((*cols, Xref, kold.astype(np.int32), ref_freq))
    for args in problems:
        got = k5_model(*args, span, rows)
        want = port_device.impute_vote_plain(*(torch.from_numpy(
            np.ascontiguousarray(a)) for a in args))
        assert np.array_equal(bits(got[0]), bits(want[0].numpy()))
        assert np.array_equal(got[1], want[1].numpy())
        assert np.array_equal(got[2], want[2].numpy().astype(bool))
        assert got[2].any() and not got[2].all()
    args = wide_segments(span + rows)
    got, want = k5_model(*args, span, rows)[0], vote_in_order(*args)
    assert np.array_equal(bits(got), bits(want)) and (got[1] != args[6]).all()


def test_k5_arguments_match_the_entry_signature(monkeypatch):
    """The arguments the wrapper hands the C entry are as many as its ctypes
    signature types, its ints where it has ints."""
    off, jref, s, e, Xref, kold, freq = (torch.from_numpy(a) for a in
                                         edge_segments(0))
    T, Nref = off.numel() - 1, Xref.shape[1]
    span = port_device.span_chunks(Xref.shape[0])
    window = port_device.window_buffers(e, T, Nref, span)
    assert [w.shape for w in window] == [e.shape, (1, T), (1 + 2 * 3,)]
    out = port_device.impute_vote_plain(off, jref, s, e, Xref, kold, freq)
    monkeypatch.setattr(kernels, "stream", lambda dev: 0)
    dev = type("Dev", (), {"index": 0})()
    args = port_device.k5_arguments(dev, off, jref, s, e, Xref, kold, freq,
                                    span, window, out)
    sig = kernels._SIGNATURES["k5_impute_vote"]
    assert len(args) == len(sig) == 19
    ints = [i for i, a in enumerate(sig) if a is kernels._I]
    assert [args[i] for i in ints] == [0, T, Nref, Nref, span]


@pytest.mark.parametrize("Nref", [1, 15, 16, 37, 256, 4_999])
def test_pitched_rows_layout(Nref):
    """K5 reads the donors' rows 16-byte aligned in a pitch that is a
    multiple of 16 bytes: reference_rows lays them out so from site-major
    columns; pitched_rows keeps rows already so (a view of wider rows
    included) and copies any others, with the same values."""
    rng = np.random.RandomState(Nref)
    X = torch.from_numpy((rng.random_sample((9, Nref)) < 0.4)
                         .astype(np.uint8))
    pitch = -(-Nref // 16) * 16
    for rows in (port_device.reference_rows(
            np.ascontiguousarray(X.numpy().T), device="cpu"),
            port_device.pitched_rows(X)):
        assert torch.equal(rows, X) and rows.stride() == (pitch, 1)
        assert rows.data_ptr() % 16 == 0
        assert port_device.pitched_rows(rows).data_ptr() == rows.data_ptr()
    wide = torch.zeros((9, pitch + 32), dtype=torch.uint8)
    view = wide[:, 16:16 + Nref]
    view.copy_(X)
    assert port_device.pitched_rows(view).data_ptr() == view.data_ptr()
    # a row's last chunk rounded up to 16 bytes would pass the storage's end
    tight = torch.zeros(8 * (pitch + 32) + Nref, dtype=torch.uint8)
    tight = tight.as_strided((9, Nref), (pitch + 32, 1))
    if Nref % 16:
        assert port_device.pitched_rows(tight).data_ptr() != tight.data_ptr()


def site_fields(p_new, p_ref):
    return (p_new.M, p_new.N, p_new.yz, p_new.zDosage,
            np.asarray(p_new.dosageOffset).tolist(),
            np.asarray(p_new.aFend).tolist(),
            [s.refFreq for s in p_ref.sites],
            [s.imputeInfo for s in p_ref.sites])


@pytest.mark.parametrize("route", ["0", "cpu", "ref_numpy"])
@pytest.mark.parametrize("seed,Mref,T,N", [(0, 40, 6, 120), (5, 300, 21, 97),
                                           (9, 600, 7, 200)])
def test_reference_impute3_matches_jax_package(monkeypatch, route, seed, Mref,
                                               T, N):
    """reference_impute3 of the port on its host C route and on the device
    route (K5's twin on CPU tensors) against pbwt_tpu.algos.impute's on its
    C runtime, and on the host C route against the JAX package held to its
    numpy routes (ref_numpy, the reference independent of the C source):
    yz, zDosage, dosageOffset, aFend, and every site's refFreq and
    imputeInfo, exactly. On the device route a frame of more than
    DEVICE_MIN_M haplotypes is matched by the imputer's DeviceMatcher,
    once, and never by the host sweep; a smaller one by the sweep."""
    from pbwt_tpu_torch.algos import match as port_match
    from pbwt_tpu_torch.ops import match as port_ops_match
    Xref, Xq, frame_idx = problem(seed, Mref, T, N)
    if route == "ref_numpy":
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    po_j, pr_j, pf_j = panels(ref_pbwt, ref_registry, Xref, Xq, frame_idx)
    want = ref_impute.reference_impute3(po_j, pr_j, pf_j)
    p_old, p_ref, p_frame = panels(port_pbwt, port_registry, Xref, Xq,
                                   frame_idx)
    monkeypatch.setenv("PBWT_TORCH_DEVICE",
                       "0" if route == "ref_numpy" else route)
    votes, matched, swept = [], [], []
    real = port_device.impute_vote
    monkeypatch.setattr(port_device, "impute_vote",
                        lambda *a: votes.append(1) or real(*a))
    real_match = port_ops_match.DeviceMatcher.match
    monkeypatch.setattr(port_ops_match.DeviceMatcher, "match",
                        lambda self, Xq: matched.append(len(Xq))
                        or real_match(self, Xq))
    real_sweep = port_impute._collect_matches
    monkeypatch.setattr(port_impute, "_collect_matches",
                        lambda *a: swept.append(1) or real_sweep(*a))
    got = port_impute.reference_impute3(p_old, p_ref, p_frame)
    assert len(votes) == (route == "cpu")
    on_matcher = route == "cpu" and Mref > port_match.DEVICE_MIN_M
    assert matched == ([T] if on_matcher else [])
    assert len(swept) == (not on_matcher)
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
