#!/usr/bin/env python3
"""What the query scan K3 costs, and why: a probe for work on
csrc/match_scan.cu.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/k3_probe.py [check] [chase] [variants] [parts]

With no argument it runs all four parts:

check     prints what ptxas says of match_scan.cu (registers, spills), builds
          the copies of the source that still compute the scan (8, 16 and 32
          lanes a query; rank-plane blocks of 2, 4 and 8 words; blocks of 32
          and 128 threads; both ranks loaded by every lane; two lanes
          loading; the site loop unrolled 1 and 8 times; loads that bypass
          L1) and holds k3_rank_plane and K3 of each against the plain twins
          on small panels (Q = 1, 24, 33, and a record cap that overflows).
          Stops at the first difference.
chase     a pointer chase (chip_smoke.py's, which takes K3's chain floor
          with it): the latency of one dependent load from L2 (one
          thread over a random cycle through the sectors of a buffer that
          every SM has read, from 4 MB up to sizes that no longer fit, on a
          stretch the chasing SM has not walked; then a whole warp loading
          16 bytes a lane as K3 does, all lanes one address, and even and
          odd lanes two), and of a walk as the scan makes it, one load a row
          at a random column, rows in address order: over the int32 rank
          table (rows of 100,352 ints, L2 flushed) and over the rank plane
          (rows of 4,184 ints; L2 flushed, and warm). Sites x the last
          latency is the least a query's chain can take.
variants  on the matching slice's panel (100,000 x 2,048, bench.py's
          bench_match_data recipe, seed 0), at Q = 256, 1,024 and 4,096: K3
          as it is (also over the first 256, 512 and 1,024 sites alone), the
          copies of `check`, and four cuts: the reset cut out (the interval
          starts again whole); the load of the plane cut out as well (a
          site's instructions alone); the int32 table U read in place of
          the plane; a persisting-L2 access window on the plane. The cuts
          compute something else than the scan: only their times mean
          anything. All copies are made by replacing lines of the source
          (the package keeps only the design it runs: a warp a query, blocks
          of 4 words; groups of 8 and 16 lanes and blocks of 2 and 8 words
          are written here), and the probe stops if a line it looks for has
          changed.
parts     DeviceMatcher.match at Q = 1,024 on that panel, stage by stage on
          the host's clock with the card synchronised between stages: host
          packing, upload, buffer fill, K3, the read of the record count,
          sort_records, expand_rows, the filter and the download.
The probe calls the C entries directly, so that a copy's layout need not be
the package's.
"""

import contextlib
import ctypes
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PANEL_M, PANEL_N = 100_000, 2_048
BATCHES = (256, 1_024, 4_096)
TABLE_STRIDE = 100_352              # ints a row of the int32 rank table
CHASE_STEPS = 1 << 15

# added to chip_smoke.py's chase source
WARP_CHASE_SOURCE = r"""
// a whole warp, 16 bytes a lane, as K3 loads: the even lanes follow one chain
// and the odd lanes another (the same one if both start alike), and a step
// ends when both loads are back
__global__ void chase_warp(const int* __restrict__ p, int even, int odd, int steps, int* out) {
  int i = (threadIdx.x & 1) ? odd : even;
  for (int s = 0; s < steps; ++s) i = __ldcg(reinterpret_cast<const int4*>(p + i)).x;
  if (threadIdx.x < 2) out[threadIdx.x] = i;
}

extern "C" int k3_chase_warp(const int* p, int even, int odd, int steps, int* out,
                             void* stream) {
  chase_warp<<<1, 32, 0, (cudaStream_t)stream>>>(p, even, odd, steps, out);
  return (int)cudaGetLastError();
}
"""

THREADS = "constexpr int K3_THREADS = 64;           // threads"
LOAD = "  int4 w = __ldg(reinterpret_cast<const int4*>(site) + b);\n"
RANK = LOAD + (
    "  return w.x + __popc((unsigned)w.y & low_bits(r)) + "
    "__popc((unsigned)w.z & low_bits(r - 32)) +\n"
    "         __popc((unsigned)w.w & low_bits(r - 64));\n")


def lanes(n):
    """The source's changes for groups of n < 32 lanes a query: the group's
    mask and lane, shuffles within the group, ballots counted from its
    first lane."""
    base = "((threadIdx.x & 31) - t)"
    return [
        ("constexpr int K3_LANES = 32;  ", f"constexpr int K3_LANES = {n};  "),
        ("constexpr unsigned GROUP = 0xffffffffu;",
         "#define GROUP (((1u << K3_LANES) - 1u) << "
         "((threadIdx.x & 31) & ~(K3_LANES - 1))) //"),
        ("  const int t = threadIdx.x & 31;  ",
         "  const int t = threadIdx.x & (K3_LANES - 1);  "),
        ("        int uf = __shfl_sync(GROUP, u, 0), ug = "
         "__shfl_sync(GROUP, u, 1);\n",
         "        int uf = __shfl_sync(GROUP, u, 0, L), ug = "
         "__shfl_sync(GROUP, u, 1, L);\n"),
        ("        fn -= __ffs(stop) - 1;\n",
         f"        fn -= __ffs(stop) - 1 - {base};\n"),
        ("      gn += __ffs(stop) - 1;\n",
         f"      gn += __ffs(stop) - 1 - {base};\n"),
    ]


def words(n):
    """The source's changes for blocks of n int32 words (2 or 8) of the
    rank plane."""
    if n == 2:
        rank = ("  int2 w = __ldg(reinterpret_cast<const int2*>(site) + b);\n"
                "  return w.x + __popc((unsigned)w.y & low_bits(r));\n")
    else:
        rank = (
            "  const int4* p = reinterpret_cast<const int4*>(site) + 2 * b;\n"
            "  int4 w = __ldg(p), v = __ldg(p + 1);\n"
            "  return w.x + __popc((unsigned)w.y & low_bits(r)) +\n"
            "         __popc((unsigned)w.z & low_bits(r - 32)) +\n"
            "         __popc((unsigned)w.w & low_bits(r - 64)) +\n"
            "         __popc((unsigned)v.x & low_bits(r - 96)) +\n"
            "         __popc((unsigned)v.y & low_bits(r - 128)) +\n"
            "         __popc((unsigned)v.z & low_bits(r - 160)) +\n"
            "         __popc((unsigned)v.w & low_bits(r - 192));\n")
    return [("constexpr int PLANE_WORDS = 4;  ",
             f"constexpr int PLANE_WORDS = {n};  "), (RANK, rank)]


STRIDE = ("  size_t plane_stride = (size_t)(mp / PLANE_ROWS + 1) * "
          "PLANE_WORDS;\n")
PERSIST = STRIDE + r"""  {
    int maxp = 0, maxw = 0;
    cudaDeviceGetAttribute(&maxp, cudaDevAttrMaxPersistingL2CacheSize, device);
    cudaDeviceGetAttribute(&maxw, cudaDevAttrMaxAccessPolicyWindowSize, device);
    size_t bytes = (size_t)ns * plane_stride * 4;
    size_t keep = bytes < (size_t)maxp ? bytes : (size_t)maxp;
    err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, keep);
    if (err != cudaSuccess) return 1000 + (int)err;
    cudaStreamAttrValue av = {};
    av.accessPolicyWindow.base_ptr = (void*)plane;
    av.accessPolicyWindow.num_bytes = bytes < (size_t)maxw ? bytes : (size_t)maxw;
    av.accessPolicyWindow.hitRatio = keep >= bytes ? 1.0f : (float)keep / (float)bytes;
    av.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    av.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    err = cudaStreamSetAttribute((cudaStream_t)stream,
                                 cudaStreamAttributeAccessPolicyWindow, &av);
    if (err != cudaSuccess) return 2000 + (int)err;
  }
"""

# variant -> (text of the source, what takes its place); those of SAME
# compute the scan itself and are held against the twin by `check`
SAME = {
    "as_is": [],
    "lanes_8": lanes(8),
    "lanes_16": lanes(16),
    "words_2": words(2),
    "words_8": words(8),
    "threads_32": [(THREADS, "constexpr int K3_THREADS = 32;  // threads")],
    "threads_128": [(THREADS, "constexpr int K3_THREADS = 128;  // threads")],
    "two_loads": [("        int u = plane_rank(site, (t & 1) ? g : f);\n", ""),
                  ("        int uf = __shfl_sync(GROUP, u, 0), ug = "
                   "__shfl_sync(GROUP, u, 1);\n",
                   "        int uf = plane_rank(site, f), ug = "
                   "plane_rank(site, g);\n")],
    "two_lanes": [("        int u = plane_rank(site, (t & 1) ? g : f);\n",
                   "        int u = 0;\n"
                   "        if (t < 2) u = plane_rank(site, t ? g : f);\n")],
    "unroll_1": [("#pragma unroll 4\n", "#pragma unroll 1\n")],
    "unroll_8": [("#pragma unroll 4\n", "#pragma unroll 8\n")],
    "bypass_l1": [(LOAD, LOAD.replace("__ldg", "__ldcg"))],
}
CUTS = {
    "no_reset": [("        int3 r = group_reset(D, A, xq, xp_words, k, f1, "
                  "g1, mp, nw, t);\n",
                  "        int3 r = make_int3(k + 1, 0, mp);\n")],
    "u_table": [("      for (int s = 0; s < send; ++s, site += plane_stride) {\n",
                 "      for (int s = 0; s < send; ++s, site += mp) {\n"),
                ("        int u = plane_rank(site, (t & 1) ? g : f);\n",
                 "        int i_ = (t & 1) ? g : f;\n"
                 "        int u = i_ == mp ? c : __ldg(site + i_);\n")],
    "persist_l2": [(STRIDE, PERSIST)],
}
# a site's instructions alone: the rank made up from the position, no load of
# the plane, and no reset (whose loads would go astray)
CUTS["no_load"] = CUTS["no_reset"] + [
    (LOAD,
     "  int4 w = make_int4(b * 48, 0x55555555, 0x55555555,\n"
     "                     0x55555555 + 0 * (int)(size_t)site);\n")]
PLANE_WORDS_OF = {"words_2": 2, "words_8": 8}


@contextlib.contextmanager
def plane_words(match, words):
    """The package's plain twins lay the rank plane out in blocks of `words`
    int32 inside the block."""
    old, match.PLANE_WORDS = match.PLANE_WORDS, words
    try:
        yield
    finally:
        match.PLANE_WORDS = old


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


def build_shared(kernels, tmp, sources):
    """name -> loaded library of each {name: CUDA source text}, one nvcc a
    source, all started together."""
    procs = {}
    for name, text in sources.items():
        src, lib = (os.path.join(tmp, f"{name}.{e}") for e in ("cu", "so"))
        with open(src, "w") as f:
            f.write(text)
        procs[name] = lib, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"k3_probe: {name} did not build:\n{out}")
        libs[name] = ctypes.CDLL(lib)
    return libs


# ---- the pointer chase: chip_smoke.py's, and a warp's beside it ----

def chase_library(kernels):
    """chip_smoke.py's chase library with k3_chase_warp added."""
    import chip_smoke
    lib = chip_smoke.chase_library(
        kernels, chip_smoke.CHASE_SOURCE + WARP_CHASE_SOURCE)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.k3_chase_warp.argtypes, lib.k3_chase_warp.restype = [P, I, I, I, P, P], I
    return lib


def chase_warp_ns(torch, kernels, lib, p, even, odd, steps):
    """A warp of 16-byte loads whose even lanes start at `even` and odd
    lanes at `odd`: nanoseconds a step."""
    out = torch.zeros(2, dtype=torch.int32, device=p.device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in "ab"]
    ev[0].record()
    err = lib.k3_chase_warp(p.data_ptr(), even, odd, steps, out.data_ptr(),
                            kernels.stream(p.device))
    if err:
        sys.exit(f"k3_probe: chase launch failed, cudaError_t {err}")
    ev[1].record()
    torch.cuda.synchronize()
    return 1e6 * ev[0].elapsed_time(ev[1]) / steps


def l2_latency_ns(torch, kernels, lib, dev, nbytes, steps=CHASE_STEPS,
                  warp=None):
    """Nanoseconds a dependent load over a warm buffer of nbytes: a random
    cycle through its 32-byte sectors. The whole buffer is read into L2
    first by every SM, as the scan's plane is; the timed stretch of
    the cycle is one the chasing SM has not walked before, so its loads hit
    wherever in L2 the sectors lie, near or far from that SM. warp: None
    one thread; "one" a warp of 16-byte loads of one address; "two" its even
    and odd lanes on two stretches of the cycle."""
    import chip_smoke
    nsec = max(nbytes // 32, 4 * steps)
    g = torch.Generator(device=dev).manual_seed(nsec)
    idx = (torch.randperm(nsec, generator=g, device=dev) * 8).to(torch.int32)
    p = torch.zeros(nsec * 8, dtype=torch.int32, device=dev)
    p[idx.long()] = idx.roll(-1)
    chip_smoke.chase_ns(torch, kernels, lib, p, int(idx[0]), steps)  # warm-up
    chip_smoke.touch(torch, kernels, lib, p)
    start = int(idx[2 * steps])
    if warp is None:
        return chip_smoke.chase_ns(torch, kernels, lib, p, start, steps)
    odd = int(idx[{"one": 2 * steps, "two": 3 * steps}[warp]])
    return chase_warp_ns(torch, kernels, lib, p, start, odd, steps)


def flush_l2(torch, dev):
    torch.empty(64 << 20, dtype=torch.int32, device=dev).fill_(1)
    torch.cuda.synchronize()


def table_latency_ns(torch, kernels, lib, dev, stride=TABLE_STRIDE,
                     steps=2_048, warm=False):
    """Nanoseconds a dependent load that walks a table as the scan does
    (chip_smoke.py's row_walk). warm=False: L2 flushed first, so every load
    goes to device memory; warm=True: the table read into L2 first by every
    SM, as chip_smoke.py's chain floor is taken."""
    import chip_smoke
    p, start = chip_smoke.row_walk(torch, dev, stride, steps)
    chip_smoke.chase_ns(torch, kernels, lib, p, start, 16)  # the kernel's code
    if warm:
        chip_smoke.touch(torch, kernels, lib, p)
    else:
        flush_l2(torch, dev)
    return chip_smoke.chase_ns(torch, kernels, lib, p, start, steps)


# ---- the scan through the C entries of any copy of the source ----

class Probe:
    def __init__(self):
        import torch
        from pbwt_tpu_torch.ops import kernels, match
        if not torch.cuda.is_available():
            sys.exit("k3_probe: needs a CUDA card")
        self.torch, self.kernels, self.match = torch, kernels, match
        self.dev = torch.device("cuda", 0)
        with open(os.path.join(kernels.CSRC, "match_scan.cu")) as f:
            self.source = f.read()

    def variants(self, names):
        """Libraries of the named copies of match_scan.cu."""
        sources = {}
        for name in names:
            text = self.source
            for old, new in {**SAME, **CUTS}[name]:
                if text.count(old) != 1:
                    sys.exit(f"k3_probe: {old!r} is not in match_scan.cu "
                             f"once")
                text = text.replace(old, new)
            sources[name] = text
        with tempfile.TemporaryDirectory(prefix="k3_probe_") as tmp:
            libs = build_shared(self.kernels, tmp, sources)
        for lib in libs.values():
            for name in ("k3_rank_plane", "k3_match_scan"):
                fn = getattr(lib, name)
                fn.argtypes = self.kernels._SIGNATURES[name]
                fn.restype = ctypes.c_int
        return libs

    def plane(self, lib, U, C, words):
        Ns, Mp = U.shape
        plane = self.torch.empty((Ns, Mp // (32 * (words - 1)) + 1, words),
                                 dtype=self.torch.int32, device=self.dev)
        err = lib.k3_rank_plane(0, U.data_ptr(), C.data_ptr(), Ns, Mp,
                                plane.data_ptr(),
                                self.kernels.stream(self.dev))
        if err:
            sys.exit(f"k3_probe: k3_rank_plane failed, cudaError_t {err}")
        return plane

    def scan(self, lib, table, D, A, C, xq, xp, cap, sites=None):
        """One launch of lib's K3 from the whole starting intervals, over
        the first `sites` sites (None: all); table is the plane (or, for
        the u_table cut, U)."""
        torch = self.torch
        Ns, Mp = D.shape
        Ns = sites or Ns
        Q, nw = xq.shape
        e = torch.zeros(Q, dtype=torch.int32, device=self.dev)
        f = torch.zeros(Q, dtype=torch.int32, device=self.dev)
        g = torch.full((Q,), Mp, dtype=torch.int32, device=self.dev)
        rec = torch.full((cap, 5), -1, dtype=torch.int32, device=self.dev)
        nrec = torch.zeros(1, dtype=torch.int32, device=self.dev)
        err = lib.k3_match_scan(
            0, table.data_ptr(), D.data_ptr(), A.data_ptr(), C.data_ptr(),
            xq.data_ptr(), xp.data_ptr(), Ns, Mp, Q, nw, e.data_ptr(),
            f.data_ptr(), g.data_ptr(), rec.data_ptr(), cap, nrec.data_ptr(),
            self.kernels.stream(self.dev))
        if err:
            sys.exit(f"k3_probe: k3_match_scan failed, code {err}")
        return e, f, g, rec, nrec

    def tables(self, Xp):
        """(A, D, U, C, xp_words, Ng) of panel Xp, as DeviceMatcher makes
        them, with U kept."""
        match = self.match
        kept = []
        real = match.rank_plane
        match.rank_plane = lambda U, C: kept.append(U) or real(U, C)
        try:
            m = match.DeviceMatcher(Xp, device=self.dev)
        finally:
            match.rank_plane = real
        return m, kept[0]

    # ---- parts ----

    def check(self):
        torch, kernels, match = self.torch, self.kernels, self.match
        src = os.path.join(kernels.CSRC, "match_scan.cu")
        with tempfile.TemporaryDirectory(prefix="k3_probe_") as tmp:
            res = subprocess.run(
                [kernels.nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", os.path.join(tmp, "m.o"), src],
                capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"k3_probe: match_scan.cu does not build:\n"
                     f"{res.stdout}{res.stderr}")
        for ln in (res.stdout + res.stderr).splitlines():
            if "registers" in ln or "spill" in ln:
                print("[ptxas] " + ln.strip(), flush=True)
        import chip_smoke
        libs = self.variants(SAME)
        for M, N, seed in ((4_500, 200, 3), (300, 70, 4), (2_047, 33, 5)):
            Xp, Xq = chip_smoke.match_data(M, N, 33, seed=seed)
            Xp[M // 2] = Xp[M // 3]              # duplicates: wide intervals
            m, U = self.tables(Xp)
            xq = torch.from_numpy(match.pack_row_words(Xq, m.Ng)).to(self.dev)
            for name, lib in libs.items():
                words = PLANE_WORDS_OF.get(name, match.PLANE_WORDS)
                plane = self.plane(lib, U, m.C, words)
                with plane_words(match, words):
                    twin = match.rank_plane_plain(U, m.C)
                if not torch.equal(plane, twin):
                    sys.exit(f"k3_probe: {name}: the plane differs from its "
                             f"twin's at {M} x {N}")
                for Q, cap in ((1, 1 << 12), (24, 1 << 12), (33, 1 << 12),
                               (33, 7)):
                    start = (torch.zeros(Q, dtype=torch.int32,
                                         device=self.dev),) * 2 + (
                        torch.full((Q,), m.Mp, dtype=torch.int32,
                                   device=self.dev),)
                    want = match.match_scan_indexed_plain(
                        twin, m.D, m.A, m.C, xq[:Q], m.xp_words, *start,
                        cap=cap)
                    got = self.scan(lib, plane, m.D, m.A, m.C,
                                    xq[:Q].contiguous(), m.xp_words, cap)
                    n = int(got[4])
                    ok = n == int(want[4]) and all(
                        torch.equal(a, b) for a, b in zip(got[:3], want[:3]))
                    if ok and n <= cap:
                        ok = torch.equal(match.sort_records(got[3], n, Q),
                                         want[3][:n])
                    if not ok:
                        sys.exit(f"k3_probe: {name}: K3 differs from its "
                                 f"twin at {M} x {N}, Q={Q}, cap={cap}")
            say("check", M=M, N=N, equal="plane,K3 x " + ",".join(libs),
                records=n)

    def chase(self):
        torch, kernels = self.torch, self.kernels
        lib = chase_library(kernels)
        for mb in (4, 8, 12, 16, 24, 34, 48, 64, 128):
            ns = l2_latency_ns(torch, kernels, lib, self.dev, mb << 20)
            say("chase", buffer_mb=mb, order="random sectors, warm",
                load_ns=f"{ns:.1f}")
        for warp in ("one", "two"):
            ns = l2_latency_ns(torch, kernels, lib, self.dev, 34 << 20,
                               warp=warp)
            say("chase", buffer_mb=34, order="random sectors, warm",
                by=f"a warp, 16 bytes a lane, {warp} address(es)",
                load_ns=f"{ns:.1f}")
        plane_stride = self.match.plane_blocks(TABLE_STRIDE) \
            * self.match.PLANE_WORDS
        for stride in (TABLE_STRIDE, plane_stride):
            for warm in (False, True):
                if warm and stride == TABLE_STRIDE:
                    continue                      # 822 MB: never warm
                ns = table_latency_ns(torch, kernels, lib, self.dev, stride,
                                      warm=warm)
                say("chase", stride_bytes=4 * stride, order="one load a row, "
                    + ("warm" if warm else "L2 flushed"), load_ns=f"{ns:.1f}")

    def panel(self):
        import chip_smoke
        Xp, Xq = chip_smoke.match_data(PANEL_M, PANEL_N, max(BATCHES))
        return Xp, Xq

    def variants_part(self):
        torch, match = self.torch, self.match
        Xp, Xq = self.panel()
        m, U = self.tables(Xp)
        xq = torch.from_numpy(match.pack_row_words(Xq, m.Ng)).to(self.dev)
        libs = self.variants([*SAME, *CUTS])
        side = torch.cuda.Stream()
        for name, lib in libs.items():
            words = PLANE_WORDS_OF.get(name, match.PLANE_WORDS)
            table = U if name == "u_table" else self.plane(lib, U, m.C, words)
            torch.cuda.synchronize()
            out = {}
            for Q in BATCHES:
                xs = xq[:Q].contiguous()

                def run():
                    return self.scan(lib, table, m.D, m.A, m.C, xs,
                                     m.xp_words, 1 << 20)
                if name == "persist_l2":       # not on the legacy stream
                    with torch.cuda.stream(side):
                        out[Q] = cuda_ms(torch, run, 5)
                else:
                    out[Q] = cuda_ms(torch, run, 5)
                records = int(run()[4])
            say("variant", name=name, plane_mb=f"{table.numel() * 4 / 1e6:.1f}",
                **{f"q{Q}_ms": f"{ms:.4f}" for Q, ms in out.items()},
                site_us_q1024=f"{1e3 * out[1_024] / PANEL_N:.4f}",
                records_q4096=records)
            if name == "as_is":
                # a shorter chain over a smaller plane: does a site cost
                # less when the plane is a quarter or a half of L2's size?
                xs = xq[:1_024].contiguous()
                for sites in (256, 512, 1_024, PANEL_N):
                    ms = cuda_ms(torch, lambda: self.scan(
                        lib, table, m.D, m.A, m.C, xs, m.xp_words, 1 << 20,
                        sites), 5)
                    say("sites", Q=1_024, sites=sites,
                        plane_mb=f"{table[:sites].numel() * 4 / 1e6:.1f}",
                        ms=f"{ms:.4f}", site_us=f"{1e3 * ms / sites:.4f}")
            del table
            torch.cuda.empty_cache()

    def parts(self):
        torch, match = self.torch, self.match
        Xp, Xq = self.panel()
        Xq = Xq[:1_024]
        m = match.DeviceMatcher(Xp, device=self.dev)
        m.match(Xq)                                    # warm-up, sets the cap
        Q = len(Xq)
        cap = m._caps[Q]
        total = {}

        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            total[name] = total.get(name, 0.0) + time.perf_counter() - t0
            return res

        reps = 10
        for _ in range(reps):
            words = stage("host_packing",
                          lambda: match.pack_row_words(Xq, m.Ng))
            xq = stage("upload",
                       lambda: torch.from_numpy(words).to(self.dev))
            start = stage("buffer_fill", lambda: (
                torch.zeros(Q, dtype=torch.int32, device=self.dev),
                torch.zeros(Q, dtype=torch.int32, device=self.dev),
                torch.full((Q,), m.Mp, dtype=torch.int32, device=self.dev)))
            e, f, g, rec, nrec = stage("k3_with_its_buffers", lambda: (
                match.match_scan_indexed(m.plane, m.D, m.A, m.C, xq,
                                         m.xp_words, *start, cap=cap)))
            n = stage("read_count", lambda: int(nrec))
            srt = stage("sort_records",
                        lambda: match.sort_records(rec, n, Q))
            rows = stage("expand_rows",
                         lambda: match.expand_rows(m.A, srt, e, f, g, m.N))
            kept = stage("filter", lambda: rows[rows[:, 1] < m.M])
            stage("download", lambda: kept.cpu().numpy())
        t0 = time.perf_counter()
        for _ in range(reps):
            m.match(Xq)
        whole = (time.perf_counter() - t0) / reps
        say("parts", Q=Q, records=n, rows=len(kept),
            **{f"{k}_ms": f"{1e3 * v / reps:.4f}" for k, v in total.items()},
            sum_ms=f"{1e3 * sum(total.values()) / reps:.4f}",
            match_ms=f"{1e3 * whole:.4f}")


def main():
    names = {"check": "check", "chase": "chase", "variants": "variants_part",
             "parts": "parts"}
    parts = sys.argv[1:] or list(names)
    if set(parts) - set(names):
        sys.exit(__doc__)
    probe = Probe()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for part in parts:
        getattr(probe, names[part])()


if __name__ == "__main__":
    main()
