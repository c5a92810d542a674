"""Multi-rank dry run of the port's sharded paths.

Counterpart of ``__graft_entry__.dryrun_multichip`` and ``_dryrun_at_scale``
(``__graft_entry__.py:63-306``). Spawns ``n`` ranks over ``torch.distributed``
and holds the haplotype-sharded build, query-sharded matching and
recipient-sharded painting against the port's host engine and its
single-device paths, exactly; then, at scale, the build at 65,536 x 1,024.
Prints measured seconds and the collective bytes a site that the group's
wrapper counted, beside the model (Mp/8 a site, and 4·Mp once for the final
prefix array).

    python -m pbwt_tpu_torch.parallel.dryrun N [--backend gloo|nccl]
        [--device cpu|cuda:0] [--no-scale]

gloo on the CPU (the default) runs the kernels' plain twins; with
``--device cuda:0`` every rank launches the kernels on that card. nccl
needs a card a rank.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from . import spawn

SCALE_MP, SCALE_N = 65_536, 1_024     # _dryrun_at_scale's build shape


def _sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launches():
    from ..ops import kernels
    return dict(kernels.LAUNCHES)


def rank_jobs(group, jobs, keep_all: bool = True):
    """The rank task of :func:`spawn`: run each job on this rank and return
    a dict a job, {"out", "s", "bytes", "launches"} (the output, on rank 0
    only unless keep_all; the seconds; the collective bytes; the kernel
    launches). A job is a tuple:

    ("build", W (Ng, Mp) words, with_divergence, n_sites): the rank's
      columns of W through ``build_scan_sharded_grouped``, outputs as numpy;
    ("pbwt", X): ``build_pbwt_sharded``;
    ("match", Xp, Xq): a ``DeviceMatcher`` of Xp on the rank's device and
      ``match_queries_sharded``;
    ("paint", sj, ss, se, seg_off, M, N, ploidy, cpr):
      ``paint_tables_sharded``.

    A job's expected launches, a dict of kernel -> count (None: at least
    one), may follow as its last element; the rank raises if they differ
    (a kernel not named must not launch)."""
    import torch

    from ..ops import kernels
    from ..ops.match import DeviceMatcher
    from . import query_sharding, sharding
    out = []
    for job in jobs:
        kind, *args = job
        expect = args.pop() if args and isinstance(args[-1], dict) else None
        before, b0 = _launches(), group.bytes
        _sync(group.device)
        t0 = time.perf_counter()
        if kind == "build":
            W, with_d, n_sites = args
            B = W.shape[1] // group.world
            Wl = torch.from_numpy(np.ascontiguousarray(
                W[:, group.rank * B:(group.rank + 1) * B])).to(group.device)
            _sync(group.device)
            t0 = time.perf_counter()
            res = sharding.build_scan_sharded_grouped(
                Wl, group, with_divergence=with_d, n_sites=n_sites)
            _sync(group.device)
            s = time.perf_counter() - t0
            res = tuple(t.cpu().numpy() for t in res)
        elif kind == "pbwt":
            res = sharding.build_pbwt_sharded(args[0], group)
            s = time.perf_counter() - t0
        elif kind == "match":
            Xp, Xq = args
            m = DeviceMatcher(Xp, device=group.device)
            m.match(Xq[:1])          # a first call loads the kernels' module
            _sync(group.device)
            t0 = time.perf_counter()
            res = query_sharding.match_queries_sharded(group, m, Xq)
            s = time.perf_counter() - t0
            del m
        elif kind == "paint":
            res = query_sharding.paint_tables_sharded(group, *args)
            s = time.perf_counter() - t0
        else:
            raise ValueError(f"unknown job {kind!r}")
        got = {k: n - before[k] for k, n in _launches().items()
               if n != before[k]}
        if expect is not None:
            for k in kernels.LAUNCHES:
                want, n = expect.get(k, 0), got.get(k, 0)
                if (n != want) if want is not None else n == 0:
                    raise RuntimeError(
                        f"rank {group.rank}: {kind} launched {k} {n} times, "
                        f"not {'at least once' if want is None else want}")
        out.append(dict(out=res if keep_all or group.rank == 0 else None,
                        s=s, bytes=group.bytes - b0, launches=got))
        if group.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def random_panel(M: int, N: int, seed: int) -> np.ndarray:
    """beta(0.2, 0.8) site frequencies (``_dryrun_at_scale``'s recipe)."""
    rng = np.random.RandomState(seed)
    freqs = rng.beta(0.2, 0.8, size=N)
    return (rng.random_sample((M, N)) < freqs[None, :]).astype(np.uint8)


def mosaic_queries(Xp: np.ndarray, Q: int, seed: int, lo: int = 10,
                   hi: int = 40) -> np.ndarray:
    """Q queries copied from panel rows in runs of lo..hi sites."""
    rng = np.random.RandomState(seed)
    M, N = Xp.shape
    Xq = np.empty((Q, N), np.uint8)
    for q in range(Q):
        pos = 0
        while pos < N:
            seg = rng.randint(lo, hi)
            Xq[q, pos:pos + seg] = Xp[rng.randint(0, M), pos:pos + seg]
            pos += seg
    return Xq


def host_build(X: np.ndarray):
    """The host engine's sorted columns, counts and end state (a, d)."""
    from ..core import engine
    M, N = X.shape
    a = np.arange(M, dtype=np.int32)
    d = np.zeros(M + 1, dtype=np.int32)
    d[0] = d[M] = 1
    Ysort = np.empty((N, M), np.uint8)
    for k in range(N):
        Ysort[k] = X[a, k]
        a, d = engine.forwards_ad(a, d, Ysort[k], k)
    return Ysort, (Ysort == 0).sum(1), a, d[:M]


def host_segments(X: np.ndarray):
    """The within-panel maximal-match segments that painting weighs, from
    the port's host collection: (sj, ss, se, seg_off)."""
    from ..algos.paint import _collect_match_arrays
    from ..core.pbwt import PBWT
    old = os.environ.get("PBWT_TORCH_DEVICE")
    os.environ["PBWT_TORCH_DEVICE"] = "0"
    try:
        p = PBWT.from_haplotypes(X)
        return tuple(np.array(a) for a in _collect_match_arrays(p))
    finally:
        if old is None:
            os.environ.pop("PBWT_TORCH_DEVICE")
        else:
            os.environ["PBWT_TORCH_DEVICE"] = old


def host_paint(sj, ss, se, seg_off, M: int, N: int, ploidy: int, cpr: int):
    """The host C pass (native paint_accumulate, no cutoff): the five
    tables."""
    from ..core import native
    n = M // ploidy
    counts, tl, c2, c3 = (np.zeros((n, n)) for _ in range(4))
    nreg = np.zeros(n)
    native.get_lib().paint_accumulate(
        sj, ss, se, seg_off, M, N, n, ploidy, cpr, -1.0, counts.reshape(-1),
        c2.reshape(-1), c3.reshape(-1), tl.reshape(-1), nreg, np.zeros(n))
    return counts, tl, c2, c3, nreg


def _equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float64:
        a, b = a.view(np.int64), b.view(np.int64)
    return a.shape == b.shape and bool(np.array_equal(a, b))


def _check(cond, msg):
    if not cond:
        raise AssertionError(f"dryrun: {msg}")


def dryrun_multichip(n: int, backend: str = "gloo", device=None,
                     scale: bool = True) -> None:
    """Run the sharded build, match and paint on n ranks and hold each
    against the host engine and the single-device path, exactly; raises
    on any difference or on a failing rank."""
    import torch

    from ..core import engine
    from ..ops import build, match, paint
    dev = torch.device(device if device is not None
                       else ("cuda:0" if backend == "nccl" else "cpu"))
    exact_paint = dev.type == "cuda"   # K6 is the host pass to the bit

    # wiring: pad rows, pad sites, a query batch n does not divide, an odd
    # number of individuals
    M, N = 32 * n - 3, 45
    X = random_panel(M, N, seed=1)
    Mp = build.pad_to(M, 32 * n)
    W = build.pack_group_words(X, Mp)
    Xp = random_panel(96, 70, seed=5)
    Xq = mosaic_queries(Xp, 2 * n + 1, seed=6)
    Xpaint = random_panel(2 * (4 * n + 1), 120, seed=7)
    segs = host_segments(Xpaint)
    Mpa, Npa = Xpaint.shape
    t0 = time.perf_counter()
    ranks = spawn(n, backend, rank_jobs,
                  [("build", W, True, N), ("pbwt", X), ("match", Xp, Xq),
                   ("paint", *segs, Mpa, Npa, 2, 3)],
                  device=None if backend == "nccl" else dev)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        _check(all(_equal(g, w) for g, w in zip(res[0]["out"],
                                                 ranks[0][0]["out"])),
               f"rank {r}'s build differs from rank 0's")
    sw, counts, a_end, d_end = ranks[0][0]["out"]
    Ysort, zeros, a, d = host_build(X)
    _check(_equal(build.unpack_columns(sw[:N], M), Ysort)
           and _equal(counts[:N], zeros) and _equal(a_end[:M], a)
           and _equal(d_end[:M], d), "build differs from the host engine")
    single = build.build_scan_grouped(
        torch.from_numpy(W).to(dev), torch.arange(Mp, dtype=torch.int32,
                                                  device=dev),
        with_divergence=True, n_sites=N)
    _check(all(_equal(g, w.cpu().numpy()) for g, w in zip(
        ranks[0][0]["out"], single)), "build differs from the single-device "
                                      "build")
    yz, aF, cnt = ranks[0][1]["out"]
    yz_h, aF_h = engine.build_from_haplotypes(X)
    _check(yz == yz_h and _equal(aF, aF_h) and _equal(cnt, zeros),
           "pack3 bytes differ from the host engine's")
    rows = ranks[0][2]["out"]
    want = match.DeviceMatcher(Xp, device=dev).match(Xq)
    _check(len(rows) > len(Xq) and _equal(rows, want),
           "sharded match rows differ from DeviceMatcher.match")
    tabs = ranks[0][3]["out"]
    single = paint.paint_tables_device(*segs, Mpa, Npa, 2, 3, device=dev)
    host = host_paint(*segs, Mpa, Npa, 2, 3)
    _check(all(_equal(g, w) for g, w in zip(tabs, single)),
           "sharded paint differs from the single-device tables")
    for g, h in zip(tabs, host):
        _check(_equal(g, h) if exact_paint else
               np.abs(g - h).max() <= 1e-12 * max(np.abs(h).max(), 1.0),
               "sharded paint differs from the host C pass")
    print(f"dryrun_multichip({n}, {backend}, {dev}): sharded build + match + "
          f"paint equal the host engine and the single-device paths (M={M}, "
          f"N={N}; match {Xp.shape[0]} x {Xp.shape[1]}, Q={len(Xq)}; paint "
          f"{Mpa // 2} individuals x {Npa}); {wall:.2f} s with the spawn",
          flush=True)
    if scale:
        _at_scale(n, backend, dev)


def _at_scale(n: int, backend: str, dev) -> None:
    """The build at 65,536 x 1,024 with divergence, against the host
    engine's end state and the single-device build; seconds, sites/s and
    collective bytes a site."""
    import torch

    from ..ops import build
    X = random_panel(SCALE_MP, SCALE_N, seed=7)
    W = build.pack_group_words(X, SCALE_MP)
    t0 = time.perf_counter()
    ranks = spawn(n, backend, rank_jobs, [("build", W, True, SCALE_N)],
                  False, device=None if backend == "nccl" else dev)
    wall = time.perf_counter() - t0
    job = ranks[0][0]
    sw, counts, a_end, d_end = job["out"]
    single = build.build_scan_grouped(
        torch.from_numpy(W).to(dev),
        torch.arange(SCALE_MP, dtype=torch.int32, device=dev),
        with_divergence=True, n_sites=SCALE_N)
    _check(all(_equal(g, w.cpu().numpy()) for g, w in zip(job["out"],
                                                          single)),
           "at scale: the build differs from the single-device build")
    t1 = time.perf_counter()
    Ysort, zeros, a, d = host_build(X)
    host_s = time.perf_counter() - t1
    _check(_equal(a_end, a) and _equal(d_end, d) and _equal(counts, zeros),
           "at scale: the build differs from the host engine")
    per_site = job["bytes"] / SCALE_N
    print(f"dryrun_at_scale({n}, {backend}, {dev}): build equal (Mp="
          f"{SCALE_MP}, N={SCALE_N}); rank 0 {job['s']:.3f} s, "
          f"{SCALE_N / job['s']:.1f} sites/s, {wall:.2f} s with the spawn; "
          f"host engine {host_s:.2f} s", flush=True)
    print(f"  build collective bytes/site counted: {per_site:.1f} "
          f"(model: Mp/8 = {SCALE_MP // 8} a site + 4·Mp once = "
          f"{SCALE_MP // 8 + 4 * SCALE_MP / SCALE_N:.1f})", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m pbwt_tpu_torch.parallel."
                                      "dryrun", description=__doc__.split(
                                          "\n\n")[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None,
                    help="every rank's device (gloo: cpu or cuda:0)")
    ap.add_argument("--no-scale", action="store_true",
                    help="skip the build at 65,536 x 1,024")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n, a.backend, a.device, scale=not a.no_scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
