#!/usr/bin/env python3
"""Probe of the port's scale-out on one CUDA card (kernel K7 and the
sharded build's site).

    python3 tools/shard_probe.py [check] [sites] [dryrun]

check   builds the kernels, prints what ptxas says of csrc/fm_step.cu
        (registers, shared memory, spills), and holds K7 against its twin,
        every output, at widths of one word to 1,048,576 rows, a whole
        share, half of one and none (the prefix pass alone);
sites   the parts of a site of the sharded build at 65,536 rows: K7's
        device time a call as 32 calls captured in a graph and replayed,
        the prefix pass alone, a call made directly, the all-reduce of the
        Mp/8-byte column; then a captured group's replay (device time by
        CUDA events, and host wall) beside the per-site path it replaces
        (a Python loop of the all-reduce, K7 and K2's single-site
        divergence step on the unpacked column), the group run directly,
        the one K2 launch over the columns, and the build's seconds a site
        with and without divergence. NCCL in a world of one here; gloo in a
        world of two processes on the card (no capture there);
dryrun  python -m pbwt_tpu_torch.parallel.dryrun 2 --device cuda:0 (gloo).
No argument runs all three. Every line carries the card's name and power
limit (nvidia-smi).
"""

import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MP, SITES = 65_536, 1_024
REPS = 200


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def event_ms(torch, fn, reps=REPS):
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def check():
    import torch

    from pbwt_tpu_torch.ops import kernels, sharding
    kernels.build(force=True)
    res = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas",
                          "-v", "-c", "-o", os.devnull,
                          os.path.join(kernels.CSRC, "fm_step.cu")],
                         capture_output=True, text=True)
    print("\n".join(ln for ln in res.stderr.splitlines()
                    if "k7" in ln or "registers" in ln or "spill" in ln))
    dev = torch.device("cuda", 0)
    err = 0
    for Mp in (32, 1024, 33 * 1024 + 32, MP, 786_432, 1_048_576):
        rng = np.random.RandomState(Mp)
        pos = torch.from_numpy(rng.permutation(Mp).astype(np.int32)).to(dev)
        w = torch.from_numpy(rng.randint(0, 2**32, size=Mp, dtype=np.uint32)
                             .astype(np.int32)).to(dev)
        colw = torch.zeros(Mp // 32, dtype=torch.int32, device=dev)
        sharding.fm_step_plain(pos, None, 0, None, Mp, nxt=colw, wn=w,
                               s_next=3)
        for B in (Mp, Mp // 2, 0):
            outs = []
            for fn in (sharding.fm_step, sharding.fm_step_plain):
                nxt = torch.zeros_like(colw)
                pref = torch.full((sharding.prefix_len(Mp),), -1,
                                  dtype=torch.int32, device=dev)
                cnt = torch.full((1,), -1, dtype=torch.int32, device=dev)
                p = fn(pos[:B], w[:B], 3, colw, Mp, nxt=nxt, wn=w[:B],
                       s_next=9, count=cnt, pref=pref)
                outs.append((p, nxt, pref, cnt))
            torch.cuda.synchronize()
            for g, t in zip(*outs):
                if g.numel():
                    err = max(err, int((g.long() - t.long()).abs().max()))
        print(f"[k7 check] Mp={Mp} max_abs_err={err}", flush=True)
    print(f"[k7 check] {'equal' if err == 0 else 'DIFFERS'} card="
          f"{card()!r}", flush=True)
    return err == 0


def host_ms(torch, fn, reps):
    """Host milliseconds a call of fn, the card synchronised at both ends."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def site_parts(group):
    """One rank's parts of a site at MP rows, and its build's seconds a
    site with and without divergence."""
    import torch

    from pbwt_tpu_torch.ops import build, kernels, partition, sharding
    from pbwt_tpu_torch.parallel import sharding as psh
    dev = group.device
    B = MP // group.world
    rng = np.random.RandomState(7)
    X = (rng.random_sample((MP, SITES)) < 0.3).astype(np.uint8)
    W = torch.from_numpy(build.pack_group_words(X, MP)[
        :, group.rank * B:(group.rank + 1) * B].copy()).to(dev)
    pos = group.rank * B + torch.arange(B, dtype=torch.int32, device=dev)
    row = torch.zeros(MP // 32, dtype=torch.int32, device=dev)
    sharding.fm_step(pos, None, 0, None, MP, nxt=row, wn=W[0], s_next=0,
                     out=pos)
    group.all_reduce(row)
    nxt = torch.zeros_like(row)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    pref = torch.empty(sharding.prefix_len(MP), dtype=torch.int32,
                       device=dev)
    out = torch.empty_like(pos)

    def k7(b=B):
        return lambda: sharding.fm_step(pos[:b], W[0, :b], 0, row, MP,
                                        nxt=nxt, wn=W[0, :b], s_next=1,
                                        count=cnt, out=out[:b], pref=pref)
    parts = dict(k7_direct_ms=event_ms(torch, k7()),
                 all_reduce_ms=event_ms(torch, lambda: group.all_reduce(nxt),
                                        100))
    if group.backend == "nccl":
        for key, b in (("k7_graph_ms", B), ("k7_prefix_graph_ms", 0)):
            k7(b)()
            g = kernels.Graph("probe", lambda: [k7(b)() for _ in range(32)])
            parts[key] = event_ms(torch, g.replay, 50) / 32
    # the per-site path the group replaces: the all-reduce, K7, and K2's
    # single-site step on the column unpacked one position an int32
    a = torch.arange(MP, dtype=torch.int32, device=dev)
    d = torch.zeros(MP, dtype=torch.int32, device=dev)
    d[0] = 1
    bits = torch.arange(32, device=dev)

    def per_site():
        group.all_reduce(nxt)
        sharding.fm_step(pos, W[0], 0, row, MP, nxt=nxt, wn=W[0], s_next=1,
                         count=cnt, out=out, pref=pref)
        col = ((row[:, None] >> bits) & 1).reshape(-1).to(torch.int32)
        partition.partition_ad_step(a, d, col, 0, 0)
    parts["per_site_path_wall_ms"] = host_ms(torch, per_site, 50)
    chase = psh.SiteGroups(W, group)
    sw = torch.zeros((SITES, MP // 32), dtype=torch.int32, device=dev)
    counts = torch.empty(SITES, dtype=torch.int32, device=dev)
    chase.run(0, sw, counts)
    parts["group_site_wall_ms"] = host_ms(
        torch, lambda: chase.run(1, sw, counts), 20) / 32
    parts["group_site_device_ms"] = event_ms(
        torch, lambda: chase.run(1, sw, counts), 20) / 32
    for with_d in (True, False):
        psh.build_scan_sharded_grouped(W[:1], group, with_d)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = psh.build_scan_sharded_grouped(W, group, with_d,
                                             n_sites=SITES)
        torch.cuda.synchronize()
        key = "site_ms" if with_d else "site_no_divergence_ms"
        parts[key] = 1e3 * (time.perf_counter() - t0) / SITES
    parts["k2_columns_ms"] = event_ms(torch, lambda: partition.ad_columns(
        res[0], a, d), 5)
    return parts


def sites():
    import torch

    from pbwt_tpu_torch import parallel
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        g = parallel.init_group("nccl", 0, 1, f"file://{tmp}/store",
                                torch.device("cuda", 0))
        try:
            parts = site_parts(g)
        finally:
            g.close()
    print("[site nccl world=1] " + " ".join(
        f"{k}={v:.4f}" for k, v in parts.items()) + f" card={card()!r}",
        flush=True)
    for r, parts in enumerate(parallel.spawn(2, "gloo", site_parts,
                                             device="cuda:0",
                                             timeout_s=600)):
        print(f"[site gloo world=2 rank={r}] " + " ".join(
            f"{k}={v:.4f}" for k, v in parts.items()) + f" card={card()!r}",
            flush=True)


def dryrun():
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m",
                          "pbwt_tpu_torch.parallel.dryrun", "2", "--device",
                          "cuda:0"], cwd=ROOT)
    print(f"[dryrun] rc={res.returncode} s={time.perf_counter() - t0:.1f} "
          f"card={card()!r}", flush=True)
    return res.returncode == 0


def main(argv):
    what = argv or ["check", "sites", "dryrun"]
    ok = True
    if "check" in what:
        ok = check() and ok
    if "sites" in what:
        sites()
    if "dryrun" in what:
        ok = dryrun() and ok
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
