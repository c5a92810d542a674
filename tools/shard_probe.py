#!/usr/bin/env python3
"""Probe of the port's scale-out on one CUDA card (kernel K7 and the
sharded build's site).

    python3 tools/shard_probe.py [check] [sites] [dryrun]

check   builds the kernels, prints what ptxas says of csrc/fm_step.cu
        (registers, shared memory, spills), and holds K7 against its twin,
        every output, at widths of one word to 1,048,576 rows;
sites   the parts of one site of the sharded build at 65,536 rows, by CUDA
        events: K7 with and without the unpacked column, K2's single-site
        divergence step on it, and the all-reduce of the Mp/8-byte column
        (NCCL in a world of one here; gloo in a world of two processes on
        the card); then the build's seconds a site with and without the
        divergence step, in each world;
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
        for B in (Mp, Mp // 2 or 1):
            outs = []
            for fn in (sharding.fm_step, sharding.fm_step_plain):
                nxt = torch.zeros_like(colw)
                col = torch.full((Mp,), -1, dtype=torch.int32, device=dev)
                cnt = torch.full((1,), -1, dtype=torch.int32, device=dev)
                p = fn(pos[:B], w[:B], 3, colw, Mp, nxt=nxt, wn=w[:B],
                       s_next=9, col=col, count=cnt)
                outs.append((p, nxt, col, cnt))
            torch.cuda.synchronize()
            for g, t in zip(*outs):
                err = max(err, int((g.long() - t.long()).abs().max()))
        print(f"[k7 check] Mp={Mp} max_abs_err={err}", flush=True)
    print(f"[k7 check] {'equal' if err == 0 else 'DIFFERS'} card="
          f"{card()!r}", flush=True)
    return err == 0


def site_parts(group):
    """One rank's parts of a site at MP rows, timed with CUDA events, and
    its build's seconds a site with and without divergence."""
    import torch

    from pbwt_tpu_torch.ops import build, partition, sharding
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
    col = torch.empty(MP, dtype=torch.int32, device=dev)
    cnt = torch.empty(1, dtype=torch.int32, device=dev)
    out = torch.empty_like(pos)
    a = torch.arange(MP, dtype=torch.int32, device=dev)
    d = torch.zeros(MP, dtype=torch.int32, device=dev)
    d[0] = 1
    sharding.fm_step(pos, W[0], 0, row, MP, nxt=nxt, wn=W[0], s_next=1,
                     col=col, count=cnt, out=out)
    parts = dict(
        k7_ms=event_ms(torch, lambda: sharding.fm_step(
            pos, W[0], 0, row, MP, nxt=nxt, wn=W[0], s_next=1, col=col,
            count=cnt, out=out)),
        k7_no_col_ms=event_ms(torch, lambda: sharding.fm_step(
            pos, W[0], 0, row, MP, nxt=nxt, wn=W[0], s_next=1, count=cnt,
            out=out)),
        k2_d_step_ms=event_ms(torch, lambda: partition.partition_ad_step(
            a, d, col, 0, 0), 100),
        all_reduce_ms=event_ms(torch, lambda: group.all_reduce(nxt), 100))
    for with_d in (True, False):
        psh.build_scan_sharded_grouped(W[:1], group, with_d)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psh.build_scan_sharded_grouped(W, group, with_d, n_sites=SITES)
        torch.cuda.synchronize()
        key = "site_ms" if with_d else "site_no_divergence_ms"
        parts[key] = 1e3 * (time.perf_counter() - t0) / SITES
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
