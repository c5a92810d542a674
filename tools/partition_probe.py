#!/usr/bin/env python3
"""What a site of K1 and K2 costs, and why: a probe for work on
csrc/partition.cu.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/partition_probe.py [check] [barrier] [shapes] [cuts] [profile]

With no argument it runs all five parts:

check    builds the kernels, prints what ptxas says of partition.cu
         (registers, spills), and holds K1 and K2 against their plain twins
         at a few small and ragged widths, for every tile size (8, 4, 2 rows
         a thread), with the words carried and gathered, and with the grid
         capped so that a block owns several tiles. Stops at the first
         difference.
barrier  times a grid barrier alone: a cooperative kernel that does nothing
         but 2,048 barriers: a counter barrier with a full fence on each
         side, cooperative_groups' grid.sync(), the counter barrier with a
         warp of pollers offset in time, and the counter barrier with a
         release add and acquire loads in place of the fences (the package's),
         over grid sizes. Sites x this time
         is the least a chain of sites can cost.
shapes   times the whole trajectory launch (K2, 100,352 rows x 2,048 sites)
         and the whole construction scan (K1, 65,536 rows x 4,096 sites) for
         each tile size, with the words carried in sort order and gathered
         through the prefix array each site, and the single-site and
         single-group calls.
cuts     builds copies of partition.cu with one part of a site taken out (the
         wait for the other tiles' summaries, the scattered stores, the grid
         barrier too, the dependent load of the word through the prefix
         array), or with wider blocks, and times the trajectory and the scan
         with each. The copies
         compute something else than the partitions: only their times mean
         anything. They are made by replacing lines of the source, and the
         probe stops if a line it looks for has changed.
profile  wall, device time and busy share (torch.profiler) of
         panel_trajectory and build_scan_grouped at those shapes, as the
         package runs them.
The probe calls the C entries directly: the package's wrappers leave the
tile size to the kernel and have made their choice of carried or gathered
words.
"""

import ctypes
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TRAJ_MP, TRAJ_NG = 100_352, 64
SCAN_MP, SCAN_NG = 65_536, 128
BARRIERS = 2_048

BARRIER_SOURCE = r"""
#include <cuda_runtime.h>
#include <cooperative_groups.h>
namespace cg = cooperative_groups;

__global__ void counter_barriers(unsigned long long* bar, int n) {
  for (int r = 0; r < n; ++r) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(bar, 1ull);
      unsigned long long target = (unsigned long long)(r + 1) * gridDim.x;
      while (*reinterpret_cast<volatile unsigned long long*>(bar) < target) {}
      __threadfence();
    }
    __syncthreads();
  }
}

// the counter barrier with a warp of pollers, each lane offset in time, so
// that the arrival of the last block is seen within a fraction of a load's
// round trip
__global__ void staggered_barriers(unsigned long long* bar, int n) {
  __shared__ int seen;
  for (int r = 0; r < n; ++r) {
    __syncthreads();
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0) {
        seen = 0;
        __threadfence();
        atomicAdd(bar, 1ull);
      }
      __syncwarp();
      unsigned long long target = (unsigned long long)(r + 1) * gridDim.x;
      __nanosleep(threadIdx.x * 20);
      while (!*reinterpret_cast<volatile int*>(&seen)) {
        if (*reinterpret_cast<volatile unsigned long long*>(bar) >= target)
          *reinterpret_cast<volatile int*>(&seen) = 1;
      }
      __syncwarp();
      if (threadIdx.x == 0) __threadfence();
    }
    __syncthreads();
  }
}

// the counter barrier with a release add and acquire loads in place of the
// two full fences
__global__ void release_acquire_barriers(unsigned long long* bar, int n) {
  for (int r = 0; r < n; ++r) {
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long target = (unsigned long long)(r + 1) * gridDim.x, seen;
      asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(bar) : "memory");
      do {
        asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(seen) : "l"(bar) : "memory");
      } while (seen < target);
    }
    __syncthreads();
  }
}

__global__ void cg_barriers(unsigned long long* bar, int n) {
  cg::grid_group g = cg::this_grid();
  for (int r = 0; r < n; ++r) g.sync();
}

extern "C" int barrier_probe(int which, int grid, int threads, int n,
                             unsigned long long* bar, void* stream) {
  void* args[] = {&bar, &n};
  void* fn = which == 0 ? (void*)counter_barriers
           : which == 1 ? (void*)cg_barriers
           : which == 2 ? (void*)staggered_barriers
                        : (void*)release_acquire_barriers;
  cudaError_t e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), args, 0,
                                              (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
"""


# variant -> (text of the source, what takes its place)
CUTS = {
    "no_exchange": [("    if ((w >> 2) == stamp) break;\n", "    break;\n")],
    "no_scatter": [("            a_dst[dst] = t.a[q];\n", ""),
                   ("            if (w_dst) w_dst[dst] = t.w[q];\n", ""),
                   ("            if constexpr (AD) d_dst[dst] = dst == 0 ? kk + 2 "
                    ": dv;\n", "")],
    "no_gather": [("__ldg(w_gat + t.a[q])", "__ldg(w_gat + t.i0 + q)")],
}
for threads in (512, 1024):       # wider blocks: fewer tiles at the same rows
    CUTS[f"threads_{threads}"] = [("constexpr int THREADS = 256;",
                                   f"constexpr int THREADS = {threads};")]
CUTS["no_sync"] = CUTS["no_exchange"] + [
    ("    if (r + 1 < p.nsites &&\n", "    if (false &&\n")]
CUTS["no_sync_no_scatter"] = CUTS["no_sync"] + CUTS["no_scatter"]
CUTS["no_sync_no_scatter_no_gather"] = (CUTS["no_sync_no_scatter"]
                                        + CUTS["no_gather"])


def say(tag, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def cuda_ms(torch, fn, reps):
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_us(event):
    """A profiler row's own time on the card (the attribute's name changed
    between PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


def words(rng, *shape):
    return rng.randint(0, 2**32, size=shape, dtype=np.uint32).astype(np.int32)


class Probe:
    def __init__(self):
        import torch
        from pbwt_tpu_torch.ops import kernels, partition
        if not torch.cuda.is_available():
            sys.exit("partition_probe: needs a CUDA card")
        self.torch, self.kernels, self.partition = torch, kernels, partition
        self.dev = torch.device("cuda", 0)
        self.rng = np.random.RandomState(4)

    def t(self, x):
        return self.torch.from_numpy(
            np.ascontiguousarray(x, np.int32)).to(self.dev)

    # ---- direct calls of the C entries, every choice an argument ----

    def entry(self, lib, name):
        """Entry ``name`` of a library built from (a copy of) the sources,
        bound as ops/kernels.py binds it; None is the package's library."""
        if lib is None:
            return getattr(self.kernels.library(), name)
        fn = getattr(lib, name)
        fn.argtypes = self.kernels._SIGNATURES[name]
        fn.restype = ctypes.c_int
        return fn

    def k2_tables(self, W, a0, d0, carry, items, max_blocks=0, lib=None):
        """The trajectory launch. With a cut-down library the tables start
        zeroed, so that a row no store reached still holds a valid index."""
        torch, kernels, partition = self.torch, self.kernels, self.partition
        Ng, Mp = W.shape
        A, D, U, C = partition._trajectory_tables(W)
        if lib is not None:
            A.zero_()
        A[0] = a0
        w_pp = torch.empty((2, Mp), dtype=torch.int32, device=self.dev) \
            if carry else None
        scratch = partition._scratch(Mp, self.dev)
        err = self.entry(lib, "k2_partition_ad_step")(
            0, A.data_ptr(), d0.data_ptr(), None, W.data_ptr(), W.stride(0),
            Mp, Ng * 32, 0, 0, A[1].data_ptr(), D.data_ptr(), U.data_ptr(),
            Mp, w_pp.data_ptr() if carry else None, C.data_ptr(),
            scratch.data_ptr(), items, max_blocks, kernels.stream(self.dev))
        if err:
            sys.exit(f"partition_probe: K2 launch failed, cudaError_t {err}")
        partition._raise_on_error(scratch, "k2_partition_ad_step")
        return A, D, U, C

    def k2_site(self, a, d, w, s, kk, items, max_blocks=0):
        """One site as a launch of its own, the words given in sort order."""
        torch, kernels, partition = self.torch, self.kernels, self.partition
        n = a.numel()
        a2, d2, w2, u = (torch.empty_like(a) for _ in range(4))
        cnt = torch.zeros(1, dtype=torch.int32, device=self.dev)
        scratch = partition._scratch(n, self.dev)
        err = self.entry(None, "k2_partition_ad_step")(
            0, a.data_ptr(), d.data_ptr(), w.data_ptr(), None, 0, n, 1, s, kk,
            a2.data_ptr(), d2.data_ptr(), u.data_ptr(), n, w2.data_ptr(),
            cnt.data_ptr(), scratch.data_ptr(), items, max_blocks,
            kernels.stream(self.dev))
        if err:
            sys.exit(f"partition_probe: K2 launch failed, cudaError_t {err}")
        partition._raise_on_error(scratch, "k2_partition_ad_step")
        return a2, d2, w2, u, cnt

    def k1_scan(self, W, a0, carry, items, max_blocks=0, lib=None):
        torch, kernels, partition = self.torch, self.kernels, self.partition
        Ng, n = W.shape
        rw = (n + 31) // 32
        a_pp = torch.zeros((2, n), dtype=torch.int32, device=self.dev)
        w_pp = torch.empty_like(a_pp) if carry else None
        ycols = torch.empty((Ng * 32, rw), dtype=torch.int32, device=self.dev)
        counts = torch.empty(Ng * 32, dtype=torch.int32, device=self.dev)
        scratch = partition._scratch(n, self.dev)
        err = self.entry(lib, "k1_group_partition")(
            0, W.data_ptr(), W.stride(0), a0.data_ptr(), n, Ng,
            a_pp.data_ptr(), w_pp.data_ptr() if carry else None,
            ycols.data_ptr(), rw, counts.data_ptr(), scratch.data_ptr(),
            items, max_blocks, kernels.stream(self.dev))
        if err:
            sys.exit(f"partition_probe: K1 launch failed, cudaError_t {err}")
        partition._raise_on_error(scratch, "k1_group_partition")
        return ycols, counts, a_pp[1]

    # ---- parts ----

    def check(self):
        torch, kernels, partition = self.torch, self.kernels, self.partition
        src = os.path.join(kernels.CSRC, "partition.cu")
        with tempfile.TemporaryDirectory(prefix="partition_probe_") as tmp:
            res = subprocess.run(
                [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", os.path.join(tmp, "p.o"), src],
                capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"partition_probe: partition.cu does not build:\n"
                     f"{res.stdout}{res.stderr}")
        for ln in (res.stdout + res.stderr).splitlines():
            if "registers" in ln or "spill" in ln:
                print("[ptxas] " + ln.strip(), flush=True)
        kernels.library()

        def equal(got, want, what):
            for i, (g, w) in enumerate(zip(got, want)):
                if not torch.equal(g, w):
                    bad = int((g != w).sum()) if g.shape == w.shape else -1
                    sys.exit(f"partition_probe: {what}: output {i} differs "
                             f"from the twin's ({bad} values)")

        for n in (1, 37, 600, 3_000, 8_193):
            w = self.t(words(self.rng, n))
            a = self.t(self.rng.permutation(n))
            d = self.t(self.rng.randint(0, 50, n))
            W = self.t(words(self.rng, 2, n))
            d0 = torch.zeros(n, dtype=torch.int32, device=self.dev)
            d0[0] = 1
            want_g = partition.group_partition_plain(w, a)
            want_g = (want_g[2], want_g[3], want_g[0])
            want_s = partition.partition_ad_step_plain(a, d, w, 5, 77)
            want_t = partition.ad_trajectory_plain(W, a, d0)
            want_k = partition.group_scan_plain(W, a)
            for items in (8, 4, 2, 0):
                for mb in (0, 1, 3):
                    tag = f"n={n} items={items} max_blocks={mb}"
                    equal(self.k1_scan(w.view(1, -1), a, True, items, mb),
                          want_g, f"K1 one group {tag}")
                    equal(self.k2_site(a, d, w, 5, 77, items, mb), want_s,
                          f"K2 one site {tag}")
                    for carry in (False, True):
                        equal(self.k2_tables(W, a, d0, carry, items, mb),
                              want_t, f"K2 64 sites carry={carry} {tag}")
                        equal(self.k1_scan(W, a, carry, items, mb), want_k,
                              f"K1 2 groups carry={carry} {tag}")
            say("check", n=n, equal="K1,K2 x items 8,4,2,auto x grid caps "
                                    "0,1,3 x words carried,gathered")

    def barrier(self):
        torch, kernels = self.torch, self.kernels
        with tempfile.TemporaryDirectory(prefix="partition_probe_") as tmp:
            src, lib = (os.path.join(tmp, f"barrier.{e}") for e in ("cu", "so"))
            with open(src, "w") as f:
                f.write(BARRIER_SOURCE)
            res = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS,
                                  "-shared", "-o", lib, src],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                sys.exit(f"partition_probe: the barrier kernels do not "
                         f"build:\n{res.stdout}{res.stderr}")
            fn = ctypes.CDLL(lib).barrier_probe
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes, fn.restype = [I, I, I, I, P, P], I
        for grid in (32, 49, 64, 98, 128, 132, 196, 264, 392, 528):
            ms = []
            for which in (0, 1, 2, 3):
                def run():
                    bar = torch.zeros(2, dtype=torch.int32, device=self.dev)
                    err = fn(which, grid, 256, BARRIERS, bar.data_ptr(),
                             kernels.stream(self.dev))
                    if err:
                        sys.exit(f"partition_probe: barrier launch failed "
                                 f"with cudaError_t {err} at grid {grid}")
                ms.append(cuda_ms(torch, run, 3))
            say("barrier", grid=grid, threads=256, barriers=BARRIERS,
                counter_us=f"{1e3 * ms[0] / BARRIERS:.3f}",
                grid_sync_us=f"{1e3 * ms[1] / BARRIERS:.3f}",
                staggered_counter_us=f"{1e3 * ms[2] / BARRIERS:.3f}",
                release_acquire_us=f"{1e3 * ms[3] / BARRIERS:.3f}")

    def shapes(self):
        torch, partition = self.torch, self.partition
        W = self.t(words(self.rng, TRAJ_NG, TRAJ_MP))
        a0 = torch.arange(TRAJ_MP, dtype=torch.int32, device=self.dev)
        d0 = torch.zeros(TRAJ_MP, dtype=torch.int32, device=self.dev)
        d0[0] = 1
        for carry in (False, True):
            for items in (8, 4, 2):
                ms = cuda_ms(torch, lambda: self.k2_tables(W, a0, d0, carry,
                                                           items), 2)
                say("k2_trajectory", Mp=TRAJ_MP, sites=TRAJ_NG * 32,
                    items=items, tiles=-(-TRAJ_MP // (256 * items)),
                    words="carried" if carry else "gathered",
                    launch_ms=f"{ms:.3f}",
                    site_us=f"{1e3 * ms / (TRAJ_NG * 32):.3f}")
        a = self.t(self.rng.permutation(TRAJ_MP))
        d = self.t(self.rng.randint(0, 50, TRAJ_MP))
        for items in (8, 4, 2):
            ms = cuda_ms(torch, lambda: self.k2_site(a, d, W[0], 7, 99,
                                                     items), 50)
            say("k2_one_site", Mp=TRAJ_MP, items=items, call_ms=f"{ms:.4f}")
        del W
        torch.cuda.empty_cache()

        W = self.t(words(self.rng, SCAN_NG, SCAN_MP))
        a0 = torch.arange(SCAN_MP, dtype=torch.int32, device=self.dev)
        for carry in (False, True):
            for items in (8, 4, 2):
                ms = cuda_ms(torch, lambda: self.k1_scan(W, a0, carry, items),
                             2)
                say("k1_scan", Mp=SCAN_MP, sites=SCAN_NG * 32, items=items,
                    tiles=-(-SCAN_MP // (256 * items)),
                    words="carried" if carry else "gathered",
                    launch_ms=f"{ms:.3f}",
                    site_us=f"{1e3 * ms / (SCAN_NG * 32):.3f}",
                    group_ms=f"{ms / SCAN_NG:.4f}")
        a = self.t(self.rng.permutation(SCAN_MP))
        for items in (8, 4, 2):
            ms = cuda_ms(torch, lambda: self.k1_scan(W[:1], a, True, items),
                         20)
            say("k1_one_group", Mp=SCAN_MP, items=items, call_ms=f"{ms:.4f}")

    def cuts(self):
        torch, kernels = self.torch, self.kernels
        with open(os.path.join(kernels.CSRC, "partition.cu")) as f:
            source = f.read()
        with tempfile.TemporaryDirectory(prefix="partition_probe_") as tmp:
            procs = {}
            for name, cuts in {"as_is": [], **CUTS}.items():
                text = source
                for old, new in cuts:
                    if text.count(old) != 1:
                        sys.exit(f"partition_probe: {old!r} is not in "
                                 f"partition.cu once")
                    text = text.replace(old, new)
                src, lib = (os.path.join(tmp, f"{name}.{e}")
                            for e in ("cu", "so"))
                with open(src, "w") as f:
                    f.write(text)
                procs[name] = lib, subprocess.Popen(
                    [kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o",
                     lib, src], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True)
            libs = {}
            for name, (lib, proc) in procs.items():
                out = proc.communicate()[0]
                if proc.returncode != 0:
                    sys.exit(f"partition_probe: {name} did not build:\n{out}")
                libs[name] = ctypes.CDLL(lib)
        Wt = self.t(words(self.rng, TRAJ_NG, TRAJ_MP))
        at = torch.arange(TRAJ_MP, dtype=torch.int32, device=self.dev)
        dt = torch.zeros(TRAJ_MP, dtype=torch.int32, device=self.dev)
        dt[0] = 1
        Ws = self.t(words(self.rng, SCAN_NG, SCAN_MP))
        as_ = torch.arange(SCAN_MP, dtype=torch.int32, device=self.dev)
        for items in (4, 2):
            for name, lib in libs.items():
                k2 = cuda_ms(torch, lambda: self.k2_tables(
                    Wt, at, dt, False, items, lib=lib), 2)
                k1 = cuda_ms(torch, lambda: self.k1_scan(
                    Ws, as_, False, items, lib=lib), 2)
                say("cuts", variant=name, items=items,
                    k2_site_us=f"{1e3 * k2 / (TRAJ_NG * 32):.3f}",
                    k1_site_us=f"{1e3 * k1 / (SCAN_NG * 32):.3f}")

    def profile(self):
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        from pbwt_tpu_torch.ops import build, match
        for name, fn, Ng, Mp in (
                ("trajectory", match.panel_trajectory, TRAJ_NG, TRAJ_MP),
                ("construction_scan", build.build_scan_grouped, SCAN_NG,
                 SCAN_MP)):
            W = self.t(words(self.rng, Ng, Mp))
            a0 = torch.arange(Mp, dtype=torch.int32, device=self.dev)
            args = [W, a0]
            if fn is match.panel_trajectory:
                d0 = torch.zeros(Mp, dtype=torch.int32, device=self.dev)
                d0[0] = 1
                args.append(d0)
            fn(*args)                                        # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn(*args)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
            rows = [(e.key, device_us(e) / 1e3, e.count)
                    for e in prof.key_averages() if device_us(e) > 0]
            dev_ms = sum(r[1] for r in rows)
            say("profile", path=name, Mp=Mp, sites=Ng * 32,
                wall_ms=f"{wall_ms:.3f}", device_ms=f"{dev_ms:.3f}",
                busy=f"{dev_ms / wall_ms:.3f}")
            for key, ms, count in sorted(rows, key=lambda r: -r[1])[:4]:
                say("profile_kernel", path=name, name=repr(key[:60]),
                    ms=f"{ms:.3f}", launches=count)
            del W, args
            torch.cuda.empty_cache()


def main():
    parts = sys.argv[1:] or ["check", "barrier", "shapes", "cuts", "profile"]
    if set(parts) - {"check", "barrier", "shapes", "cuts", "profile"}:
        sys.exit(__doc__)
    probe = Probe()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for part in parts:
        getattr(probe, part)()


if __name__ == "__main__":
    main()
