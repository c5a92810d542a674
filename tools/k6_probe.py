#!/usr/bin/env python3
"""What a correctly rounded f64 division costs on the card, for the bound of
painting's kernel K6 (csrc/paint.cu), and what ptxas makes of K6 and of
k3_rank_plane (csrc/match_scan.cu).

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/k6_probe.py
    python3 tools/k6_probe.py variants
    python3 tools/k6_probe.py stages
    python3 tools/k6_probe.py cells N [N ...]    (on the CPU, no card needed)

With no argument it prints one line each:
  sass    the fast path of one __ddiv_rn as nvcc compiles it for sm_90a (the
          kernel out[i] = __ddiv_rn(x[i], y[i]), its instructions up to its
          first EXIT that no predicate guards; the slow path, a subroutine
          for operands near the ends of the range, lies after it): the count
          of each f64 opcode and of MUFU.RCP64H, and its DFMA-equivalents:
          one for each instruction of the f64 pipe, four for the reciprocal
          seed (an SM's SFUs take 16 lanes a clock, its f64 pipe 64);
  rate    divisions and fused multiply-adds a second on the card, every
          thread running 8 independent chains of 1,024 of them at full
          occupancy, and the ratio of the two: the card's own count of
          DFMA-equivalents a division;
  ptxas   registers, spills and shared memory of k6_norm, k6_cells and
          k3_plane (nvcc -Xptxas -v).
`variants` builds copies of csrc/paint.cu with other block shapes (the
lines it replaces are checked) and times K6's two phases of each, called
directly through the C entry, on the painting path's segments (chip_smoke.py's
panel, -paint OUT 100 2), each copy's tables held against the package's bit
for bit. Copies marked "cut" leave part of a phase out and only their times
mean anything.
`stages`, on the same segments: phase 2 under four schedules of the cells
(the package's, by power of two of their pairs then key; key order; most
pairs first; a random order) and the heaviest cell alone; a torch.profiler
table of the wrapper's preparation; and the running max of _windows as
one 1-D torch.cummax beside ops/partition.py's blocked one.
`cells` makes chip_smoke.py's painting panel (5,008 haplotypes, the copy
model's founders, a 0.1% switch rate a site) at N sites on the host, runs
K6's preparation on CPU tensors and prints its cells: their count, the
weighed pairs a cell (mean, largest, 99th percentile) and the intervals a
cell. The numbers come from the CPU and are no device metric.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHAINS, ITERS, THREADS, BLOCKS_PER_SM = 8, 1_024, 128, 16
SFU_WEIGHT = 4        # f64 lanes an SM issues a clock / SFU lanes (64 / 16)

SOURCE = r"""
extern "C" __global__ void one_div(const double* x, const double* y, double* z, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) z[i] = __ddiv_rn(x[i], y[i]);
}

template <bool DIV>
__global__ void chains(const double* x, double* z, int iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const double d = 1.0 + x[i & 1023] * 1e-9, e = x[(i + 7) & 1023] * 1e-9;
  double a[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) a[c] = 1.0 + c * 1e-3 + x[(i + c) & 1023];
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) a[c] = DIV ? __ddiv_rn(a[c], d) : __fma_rn(a[c], d, e);
  double s = 0.0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += a[c];
  z[i] = s;
}

extern "C" int run_chains(int divide, const double* x, double* z, int blocks, int threads,
                          int iters, void* stream) {
  if (divide)
    chains<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(x, z, iters);
  else
    chains<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(x, z, iters);
  return (int)cudaGetLastError();
}
"""

F64_PIPE = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX")
SEED = "MUFU.RCP64H"


def say(tag, **kv):
    print(json.dumps({"probe": tag, **kv}), flush=True)


def run(cmd):
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        sys.exit(f"{' '.join(cmd)} failed:\n{res.stdout}{res.stderr}")
    return res.stdout + res.stderr


def fast_path(sass: str, name: str) -> list[str]:
    """Opcodes of function `name` up to its first unguarded EXIT."""
    body = sass.split(f"Function : {name}", 1)[1].split("Function :", 1)[0]
    ops = []
    for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         body):
        ops.append(m.group(2))
        if m.group(2) == "EXIT" and not m.group(1):
            break
    return ops


# name -> ((line of csrc/paint.cu, its replacement), ...), cut
VARIANTS = {
    "as_is": ((), False),
    "norm_256x1024": ((("constexpr int NORM_THREADS = 128;",
                        "constexpr int NORM_THREADS = 256;"),
                       ("constexpr int NORM_SITES = 512;",
                        "constexpr int NORM_SITES = 1024;")), False),
    "norm_no_scatter": ((("      if (a >= c1) break;",
                          "      if (a >= c1 || a < c1) break;"),), True),
    "cells_256": ((("constexpr int CELL_THREADS = 128;",
                    "constexpr int CELL_THREADS = 256;"),), False),
    "cells_no_division": (
        (("const double w = __ddiv_rn(__dmul_rn((double)(k - v.z), (double)(v.w - k)), z);\n"
          "          const double tc = __ddiv_rn(w, (double)(v.w - v.z));",
          "const double w = __dmul_rn(__dmul_rn((double)(k - v.z), (double)(v.w - k)), z);\n"
          "          const double tc = __dmul_rn(w, (double)(v.w - v.z));"),), True),
}


def variants():
    from pbwt_tpu_torch.ops import kernels
    nvcc = kernels.nvcc()
    base = open(os.path.join(kernels.CSRC, "paint.cu")).read()
    with tempfile.TemporaryDirectory(prefix="k6_variants_") as tmp:
        time_variants(base, nvcc, tmp)


def time_variants(base, nvcc, tmp):
    import numpy as np
    import torch
    import chip_smoke as cs
    from pbwt_tpu_torch.ops import kernels, paint
    procs, libs = [], {}
    for name, (edits, _) in VARIANTS.items():
        text = base
        for old, new in edits:
            if text.count(old) != 1:
                sys.exit(f"variant {name}: the line {old!r} has changed")
            text = text.replace(old, new)
        src = os.path.join(tmp, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        libs[name] = os.path.join(tmp, f"lib{name}.so")
        procs.append(subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", libs[name], src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out = p.communicate()[0]
        if p.returncode:
            sys.exit(out)
    dev = torch.device("cuda", 0)
    args = path_segments(torch, cs, paint, dev)
    M, N, ploidy = args[4:7]
    want = paint.download_tables(paint.paint_accumulate(*args))
    prep = paint.prepare(*args)
    n = M // ploidy
    ssum = torch.empty((M, N), dtype=torch.float64, device=dev)
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip()
    for name, (_, cut) in VARIANTS.items():
        fn = ctypes.CDLL(libs[name]).k6_paint_accumulate
        fn.argtypes = kernels._SIGNATURES["k6_paint_accumulate"]
        tables = [torch.zeros((n, n), dtype=torch.float64, device=dev)
                  for _ in range(4)]

        def phase(p):
            assert fn(*paint.k6_arguments(dev, M, N, prep, ssum, tables,
                                          p)) == 0

        phase(3)
        got = paint.download_tables(tables)
        same = all(np.array_equal(g.view(np.int64), w.view(np.int64))
                   for g, w in zip(got, want[:4]))
        if not (same or cut):
            sys.exit(f"variant {name} differs from the package's K6")
        say("variant", name=name, cut=cut, bits=same, card=card,
            norm_ms=f"{cs.cuda_ms(torch, lambda: phase(1), 5):.4f}",
            cells_ms=f"{cs.cuda_ms(torch, lambda: phase(2), 5):.4f}")


def path_segments(torch, cs, paint, dev):
    M, N, ploidy, cpr = cs.PAINT_M, cs.PAINT_N, cs.PAINT_PLOIDY, cs.PAINT_CPR
    X = cs.ls_panel(M, N, switch=cs.PAINT_SWITCH)
    off, sj, ss, se = paint.upload_segments(*cs.panel_segments(X), dev)
    return (off, sj, ss, se, M, N, ploidy, cpr)


def stages():
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from pbwt_tpu_torch.ops import kernels, paint, partition
    dev = torch.device("cuda", 0)
    args = path_segments(torch, cs, paint, dev)
    ss, se, M, N, ploidy = args[2:7]
    prep = paint.prepare(*args)
    n = M // ploidy
    ssum = torch.empty((M, N), dtype=torch.float64, device=dev)
    tables = [torch.zeros((n, n), dtype=torch.float64, device=dev)
              for _ in range(4)]
    lib = kernels.library()
    assert lib.k6_paint_accumulate(*paint.k6_arguments(
        dev, M, N, prep, ssum, tables, 1)) == 0
    iv = prep.cell_iv.long()
    done = torch.zeros(iv.shape[0] + 1, dtype=torch.long, device=dev)
    done[1:] = torch.cumsum(iv[:, 1] - iv[:, 0], 0)
    pairs = done[prep.cell_off[1:]] - done[prep.cell_off[:-1]]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    orders = {
        "power_of_two_then_key": prep.sched,
        "key": torch.arange(pairs.numel(), device=dev),
        "most_pairs_first": torch.sort(-pairs, stable=True).indices,
        "random": torch.randperm(pairs.numel(), device=dev, generator=g),
        "heaviest_alone": torch.sort(-pairs).indices[:1]}
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip()
    for name, order in orders.items():
        p2 = prep._replace(sched=order.to(torch.int32).contiguous())
        ms = cs.cuda_ms(torch, lambda: lib.k6_paint_accumulate(
            *paint.k6_arguments(dev, M, N, p2, ssum, tables, 2)), 3)
        say("schedule", name=name, cells=order.numel(), cells_ms=f"{ms:.4f}",
            heaviest_pairs=int(pairs.max()), card=card)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        paint.prepare(*args)
        torch.cuda.synchronize()
    for ev in sorted(prof.key_averages(), key=lambda e: -e.device_time_total
                     )[:8]:
        if ev.key.startswith("aten::"):
            say("prepare_op", op=ev.key, calls=ev.count,
                device_ms=f"{ev.device_time_total / 1e3:.4f}")
    say("prepare", ms=f"{cs.cuda_ms(torch, lambda: paint.prepare(*args), 5):.4f}",
        card=card)
    v = torch.minimum(se.long(), ss.long() + 1)  # what _windows scans
    say("cummax", values=v.numel(),
        torch_1d_ms=f"{cs.cuda_ms(torch, lambda: torch.cummax(v, 0), 3):.4f}",
        blocked_ms=f"{cs.cuda_ms(torch, lambda: partition._cummax(v), 3):.4f}",
        card=card)


def cells(sites):
    import numpy as np
    import torch
    import chip_smoke as cs
    from pbwt_tpu_torch.ops import paint
    for N in sites:
        X = cs.ls_panel(cs.PAINT_M, N, switch=cs.PAINT_SWITCH)
        sj, ss, se, off = cs.panel_segments(X)
        cols = [torch.from_numpy(a) for a in (off, sj, ss, se)]
        prep = paint.prepare(*cols, cs.PAINT_M, N, cs.PAINT_PLOIDY,
                             cs.PAINT_CPR)
        iv, co = prep.cell_iv.long(), prep.cell_off
        done = torch.zeros(iv.shape[0] + 1, dtype=torch.long)
        done[1:] = torch.cumsum(iv[:, 1] - iv[:, 0], 0)
        pairs = (done[co[1:]] - done[co[:-1]]).numpy()
        say("cells", M=cs.PAINT_M, N=N, segments=len(sj),
            intervals=iv.shape[0], cells=len(pairs), pairs=int(pairs.sum()),
            pairs_mean=float(pairs.mean()), pairs_max=int(pairs.max()),
            pairs_p99=float(np.percentile(pairs, 99)),
            intervals_a_cell=float(np.diff(co.numpy()).mean()))


def main():
    if sys.argv[1:2] == ["cells"]:
        return cells([int(n) for n in sys.argv[2:]])
    if sys.argv[1:2] == ["variants"]:
        return variants()
    if sys.argv[1:2] == ["stages"]:
        return stages()
    import torch
    from pbwt_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        sys.exit("tools/k6_probe.py needs a CUDA card")
    with tempfile.TemporaryDirectory(prefix="k6_probe_") as tmp:
        probe(torch, kernels, kernels.nvcc(), tmp)


def probe(torch, kernels, nvcc, tmp):
    src = os.path.join(tmp, "div.cu")
    with open(src, "w") as f:
        f.write(f"#define CHAINS {CHAINS}\n" + SOURCE)
    cubin, lib = os.path.join(tmp, "div.cubin"), os.path.join(tmp, "libdiv.so")
    run([nvcc, *kernels.NVCC_FLAGS, "-cubin", "-o", cubin, src])
    sass = run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin])
    ops = fast_path(sass, "one_div")
    count = {op: sum(o.startswith(op) for o in ops) for op in (*F64_PIPE, SEED)}
    equiv = sum(count[op] for op in F64_PIPE) + SFU_WEIGHT * count[SEED]
    say("sass", function="one_div", instructions=len(ops), **count,
        dfma_equivalents=equiv, sequence=" ".join(ops))

    run([nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", lib, src])
    dll = ctypes.CDLL(lib)
    dll.run_chains.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    x = torch.rand(1024, dtype=torch.float64, device=dev)
    z = torch.empty(blocks * THREADS, dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rates = {}
    for name, divide in (("ddiv", 1), ("dfma", 0)):
        def launch():
            assert dll.run_chains(divide, x.data_ptr(), z.data_ptr(), blocks,
                                  THREADS, ITERS, stream) == 0
        launch()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            launch()
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / 5
        rates[name] = blocks * THREADS * CHAINS * ITERS / (ms * 1e-3)
        assert torch.isfinite(z).all()
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip()
    say("rate", card=card, ddiv_per_s=f"{rates['ddiv']:.4g}",
        dfma_per_s=f"{rates['dfma']:.4g}",
        dfma_equivalents=f"{rates['dfma'] / rates['ddiv']:.3f}")

    for name in ("paint.cu", "match_scan.cu"):
        out = run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                   os.path.join(tmp, name + ".o"),
                   os.path.join(kernels.CSRC, name)])
        for part in out.split("Compiling entry function '")[1:]:
            fn = part.split("'", 1)[0]
            if "k6_" in fn or "k3_plane" in fn:
                info = [ln.split(":", 1)[-1].strip() for ln in part.splitlines()
                        if "spill" in ln or "Used" in ln]
                say("ptxas", source=name, function=fn, info="; ".join(info))


if __name__ == "__main__":
    main()
