#!/usr/bin/env python3
"""Painting's within-panel match collection on the card (ops/paint.py:
collect_matches: k1_decode_columns, K2's k2_partition_ad_table, K9
k9_max_within) against the host C runtime's max_within_bucketed, and the
trajectory's launch shape.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/collect_probe.py [check] [grid] [stages]

(all three without an argument). Each prints one JSON line:
  check   the card's (sj, ss, se, seg_off) against the host's, element for
          element, at edge shapes (M not a multiple of 32, N = 1, runs of
          identical haplotypes, a start prefix array, several chunks of
          sites) and at chip_smoke.py's painting panel (5,008 x 16,384);
          a truncated stream and a run across a site's end must raise;
  grid    the trajectory's microseconds a site under each launch shape
          (rows a thread 2, 4, 8 x a cap of 1, 2, 3, 5, 10 blocks or the
          kernel's own), at 2,504, 5,008, 10,016 and 20,032 haplotypes x
          2,048 sites, each the median of 3 launches by CUDA events;
  stages  the collection's stages at 5,008 x 16,384 by CUDA events (the
          upload, decode, trajectory at the kernel's own launch shape, both
          K9 passes, the counts' scan over the sites with a clone of them
          and the clone alone), the whole call's wall, and the host C
          pass's.
The card's name and power limit head each line.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("PBWT_TORCH_DEVICE", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pbwt_tpu_torch.core import native  # noqa: E402
from pbwt_tpu_torch.ops import build, kernels, paint, partition  # noqa: E402

M_PAINT, N_PAINT = 5_008, 16_384


def card():
    lim = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    return lim or torch.cuda.get_device_name(0)


def mosaic(M, N, seed=0, switch=0.001, founders=200):
    """chip_smoke.py's panels: mosaics of founders with beta(0.2, 0.8)
    site frequencies, a switch rate a site, 0.5% allele noise."""
    rng = np.random.RandomState(seed)
    freqs = rng.beta(0.2, 0.8, size=N)
    F = (rng.random_sample((founders, N)) < freqs).astype(np.uint8)
    src = rng.randint(founders, size=M)
    X = np.empty((M, N), np.uint8)
    for k in range(N):
        sw = rng.random_sample(M) < switch
        src[sw] = rng.randint(founders, size=int(sw.sum()))
        X[:, k] = F[src, k]
    X ^= (rng.random_sample((M, N)) < 0.005).astype(np.uint8)
    return X


def pack3(X, a0=None):
    """(yz, aFend) of the host C build from the start prefix array a0."""
    M = X.shape[0]
    return native.build_pbwt(np.ascontiguousarray(X.T), np.arange(
        M, dtype=np.int32) if a0 is None else a0)


def host(yz, M, N, a0):
    return native.max_within_bucketed(yz, M, N, a0)


def same(want, got):
    return all(np.array_equal(np.asarray(w), g.cpu().numpy())
               for w, g in zip(want, got))


def check():
    dev = torch.device("cuda", 0)
    out = []
    cases = [("odd_M", mosaic(37, 300, 1, 0.02, 5), None, None),
             ("N1", mosaic(64, 1, 2), None, None),
             ("identical", np.repeat(mosaic(8, 200, 3, 0.02, 3), 9, 0), None,
              None),
             ("aFstart", mosaic(100, 257, 4, 0.02, 7), "perm", None),
             ("chunks", mosaic(300, 700, 5, 0.01, 20), None, 12 * 300 * 97),
             ("two", mosaic(2, 50, 6, 0.05, 2), None, None),
             ("paint", mosaic(M_PAINT, N_PAINT), None, None)]
    for name, X, start, budget in cases:
        M, N = X.shape
        a0 = (np.random.RandomState(7).permutation(M).astype(np.int32)
              if start else np.arange(M, dtype=np.int32))
        yz, _ = pack3(X, a0)
        t0 = time.perf_counter()
        want = host(yz, M, N, a0)
        host_s = time.perf_counter() - t0
        old = paint.COLLECT_BYTES
        if budget:
            paint.COLLECT_BYTES = budget
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = paint.collect_matches(yz, M, N, a0, dev)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
        finally:
            paint.COLLECT_BYTES = old
        out.append(dict(case=name, M=M, N=N, segments=len(want[0]),
                        equal=same(want, got), card_ms=round(1e3 * card_s, 3),
                        host_ms=round(1e3 * host_s, 3)))
    X = mosaic(40, 30, 8, 0.05, 4)
    yz, _ = pack3(X)
    raised = []
    for bad in (yz[:-1], bytes([0x80 | 41]) + yz[1:]):
        try:
            build.decode_columns(torch.frombuffer(bytearray(bad),
                                                  dtype=torch.uint8).to(dev),
                                 30, 40)
            raised.append(False)
        except ValueError:
            raised.append(True)
    ok = all(c["equal"] for c in out) and all(raised)
    print(json.dumps(dict(probe="check", card=card(), ok=ok, cases=out,
                          malformed_raised=raised)), flush=True)
    return ok


def events_ms(fn, reps=3):
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def grid():
    dev = torch.device("cuda", 0)
    rows = []
    for M in (2_504, 5_008, 10_016, 20_032):
        N = 2_048
        yz, _ = pack3(mosaic(M, N))
        ycols = build.decode_columns(torch.frombuffer(
            bytearray(yz), dtype=torch.uint8).to(dev), N, M)
        A = torch.empty((N + 1, M), dtype=torch.int32, device=dev)
        D = torch.empty_like(A)
        A[0] = torch.arange(M, dtype=torch.int32, device=dev)
        D[0] = 0
        scratch = partition._scratch(M, dev)
        ref = None
        res = {}
        for items in (2, 4, 8):
            for blocks in (1, 2, 3, 5, 10, 0):
                def run():
                    kernels.launch("k2_partition_ad_table", dev.index,
                                   ycols.data_ptr(), ycols.shape[1],
                                   A.data_ptr(), D.data_ptr(), M, N, 0,
                                   scratch.data_ptr(), items, blocks,
                                   kernels.stream(dev))
                    partition._raise_on_error(scratch,
                                              "k2_partition_ad_table")
                ms = events_ms(run)
                got = (A.clone(), D.clone())
                if ref is None:
                    ref = got
                equal = bool(torch.equal(ref[0], got[0])
                             and torch.equal(ref[1], got[1]))
                res[f"{items}x{blocks}"] = (round(1e3 * ms / N, 3), equal)
        best = min(res, key=lambda k: res[k][0])
        rows.append(dict(M=M, N=N, us_a_site=res, best=best))
    print(json.dumps(dict(probe="grid", card=card(), rows=rows)), flush=True)
    return all(v[1] for r in rows for v in r["us_a_site"].values())


def stages():
    dev = torch.device("cuda", 0)
    M, N = M_PAINT, N_PAINT
    yz, _ = pack3(mosaic(M, N))
    a0 = np.arange(M, dtype=np.int32)
    t0 = time.perf_counter()
    want = host(yz, M, N, a0)
    host_s = time.perf_counter() - t0
    got = paint.collect_matches(yz, M, N, a0, dev)        # warm
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        got = paint.collect_matches(yz, M, N, a0, dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    z = torch.frombuffer(bytearray(yz), dtype=torch.uint8).to(dev)
    out = dict(upload_ms=events_ms(lambda: torch.frombuffer(
        bytearray(yz), dtype=torch.uint8).to(dev)))
    out["decode_ms"] = events_ms(lambda: build.decode_columns(z, N, M))
    ycols = build.decode_columns(z, N, M)
    A = torch.empty((N + 1, M), dtype=torch.int32, device=dev)
    D = torch.empty_like(A)
    A[0] = torch.from_numpy(a0).to(dev)
    D[0] = 0
    out["trajectory_ms"] = events_ms(lambda: partition.ad_table(ycols, A, D))
    counts = torch.empty((M, N + 1), dtype=torch.int32, device=dev)
    out["count_ms"] = events_ms(
        lambda: paint.max_within_count(A, D, ycols, 0, N, counts))
    tot = counts.sum(1, dtype=torch.int64)
    out["scan_ms"] = events_ms(lambda: counts.clone().cumsum_(1))
    out["clone_ms"] = events_ms(lambda: counts.clone())
    counts.cumsum_(1)
    off = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    torch.cumsum(tot, 0, out=off[1:])
    n = int(off[-1])
    seg = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    out["fill_ms"] = events_ms(lambda: paint.max_within_fill(
        A, D, ycols, 0, N, counts, off[:-1], *seg))
    ok = same(want, got) and same(want, (*seg, off))
    print(json.dumps(dict(
        probe="stages", card=card(), ok=ok, M=M, N=N, segments=n,
        yz_bytes=len(yz),
        **{k: round(v, 4) for k, v in out.items()},
        collect_wall_ms=[round(1e3 * w, 2) for w in walls],
        host_ms=round(1e3 * host_s, 1))), flush=True)
    return ok


def main():
    parts = sys.argv[1:] or ["check", "grid", "stages"]
    kernels.library()
    ok = True
    for p in parts:
        ok &= {"check": check, "grid": grid, "stages": stages}[p]()
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
