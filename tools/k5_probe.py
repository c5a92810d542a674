#!/usr/bin/env python3
"""What reference imputation's vote kernel K5 (csrc/impute_vote.cu) spends
its time on, at the -referenceImpute path's shape.

Run from the repository root:

    python3 tools/k5_probe.py                (on a machine with one CUDA card)
    python3 tools/k5_probe.py count N [N ...]       (on the CPU, no card needed)

The inputs are those of chip_smoke.py's imputation slice, made in memory by
its recipe (chip_smoke.py: impute_files): 20,000 reference and 2,000 target
haplotypes, mosaics of the copy model's founders with a 0.1% switch rate a
site, the targets typed at every 8th site; the frame's maximal matches of
each target (the sweep of algos/impute.py) and the frame coordinate of each
reference site, at N sites (16,384 with no argument).

With no argument, on the card, one JSON line each:
  inputs   the segments and covering (segment, site) pairs (the path's
           counts: 517,583 and 302,381,464), and the card;
  ptxas    registers, spills and shared memory of each k5_vote (nvcc
           -Xptxas -v);
  variant  the C entry's time (CUDA events, warm; its pre-pass included) of
           copies of csrc/impute_vote.cu, each held against the twin bit
           for bit unless it is a cut: as_is (its pre-pass also held against
           vote_window); rows_16 (16 segments a slot, not 32); slots_3 and
           slots_4 (a ring of 3 or 4 slots, not 2); grid_skew (the blocks
           running together on different spans); stores_scalar (a store a
           site); min_blocks_1 and min_blocks_12 (registers capped for 1 or
           12 blocks an SM, not 10); never_same (no weight shared by the
           sites of one frame coordinate); f64_walk (every sum in f64, never
           the integer regime); always_divide (a division at every site);
           and cuts,
           whose results are wrong and only their times mean anything:
           prepass_only (k5_bounds and k5_window alone), no_walk (the run
           packed and its rows copied, no walk), no_copies (the walk reads a
           constant in place of the staged alleles; no copies), window_only
           (neither), stores_only (no segment read: the stores of ref_freq
           alone). And the earlier design ("old", OLD_SOURCE: a block a
           (target, chunk), every block reading all of its target's
           segments, a global load a covering pair), held like the others
           against the twin bit for bit;
  span     the package's source at 4, 8, 16 and 32 chunks a block (the
           wrapper's SPAN_L2_BYTES halved, as it is, doubled and
           quadrupled: a slab of Mref x span x 256 bytes), each held
           against the twin bit for bit;
  nref     at 16,383 sites (the path's inputs without their last site, in
           rows of a 16,384-byte pitch, as reference_rows lays them out):
           the package's source and the earlier design, held against the
           twin bit for bit; impute_vote on contiguous rows of 16,383
           bytes, which it first copies to that pitch; and the rows made
           from site-major columns on the card at 16,383 and 16,384 sites,
           into the pitch (pitched_rows) and contiguous; and contiguous
           rows of 16,383 laid out in the pitch by pitched_rows (copy_), by
           torch.cat with a zero column block and by F.pad;
  write_floor  torch's fill_ of the three outputs (dosage, x, voted): the
           card's rate for K5's writes alone;
  wrapper  impute_vote as the path calls it, and the pre-pass's plain twin
           (vote_window, torch) for comparison.
`count` runs on the CPU: per (target, chunk of 256 sites) the segments that
can weigh there (s below the chunk's largest frame coordinate, e above its
least), as K5 packs them: mean, largest, 99th percentile, the share of
chunks with more than a slot holds (32), and the covering pairs. The
numbers come from the CPU and are no device metric.
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROWS = 32           # segments a slot of K5 (csrc/impute_vote.cu)

OLD_SOURCE = r"""
#include <cuda_runtime.h>
#include <climits>
namespace {
constexpr int CHUNK = 256;
constexpr int WARPS = CHUNK / 32;
__global__ void __launch_bounds__(CHUNK)
k5_vote(const long long* __restrict__ seg_off, const int* __restrict__ seg_jref,
        const int* __restrict__ seg_s, const int* __restrict__ seg_e,
        const unsigned char* __restrict__ Xref, int nref, const int* __restrict__ kold,
        const double* __restrict__ ref_freq, double* __restrict__ dosage,
        unsigned char* __restrict__ x, unsigned char* __restrict__ voted) {
  __shared__ int sh_j[CHUNK], sh_s[CHUNK], sh_e[CHUNK];
  __shared__ int sh_lo[WARPS], sh_hi[WARPS], sh_n[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const int k = blockIdx.y * CHUNK + tid;
  const bool live = k < nref;
  const int ko = live ? kold[k] : 0;
  int lo = live ? ko : INT_MAX, hi = live ? ko : INT_MIN;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) { sh_lo[warp] = lo; sh_hi[warp] = hi; }
  __syncthreads();
  lo = sh_lo[0];
  hi = sh_hi[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) { lo = min(lo, sh_lo[w]); hi = max(hi, sh_hi[w]); }
  double ssum = 0.0, score = 0.0;
  const unsigned char* xk = Xref + k;
  const long long end = seg_off[t + 1];
  for (long long base = seg_off[t]; base < end; base += CHUNK) {
    const long long i = base + tid;
    int j = 0, s = 0, e = 0;
    bool keep = false;
    if (i < end) {
      s = seg_s[i];
      e = seg_e[i];
      keep = s < hi && e > lo;
      if (keep) j = seg_jref[i];
    }
    const unsigned kept = __ballot_sync(0xffffffffu, keep);
    __syncthreads();
    if (lane == 0) sh_n[warp] = __popc(kept);
    __syncthreads();
    int at = __popc(kept & ((1u << lane) - 1u)), n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) { if (w < warp) at += sh_n[w]; n += sh_n[w]; }
    if (keep) { sh_j[at] = j; sh_s[at] = s; sh_e[at] = e; }
    __syncthreads();
    if (!live) continue;
    for (int m = 0; m < n; ++m) {
      const int sm = sh_s[m];
      if (sm >= ko) continue;
      const double w = __dmul_rn((double)(ko - sm), (double)(sh_e[m] - ko));
      if (w > 0.0) {
        ssum = __dadd_rn(ssum, w);
        if (xk[(size_t)sh_j[m] * nref]) score = __dadd_rn(score, w);
      }
    }
  }
  if (!live) return;
  const size_t o = (size_t)t * nref + k;
  const double d = ssum == 0.0 ? ref_freq[k] : __ddiv_rn(score, ssum);
  dosage[o] = d;
  x[o] = d > 0.5;
  voted[o] = ssum != 0.0;
}
}  // namespace
extern "C" int k5_old(int device, const long long* seg_off, const int* seg_jref, const int* seg_s,
                      const int* seg_e, int nt, const unsigned char* Xref, int nref, const int* kold,
                      const double* ref_freq, double* dosage, unsigned char* x,
                      unsigned char* voted, void* stream) {
  cudaSetDevice(device);
  k5_vote<<<dim3(nt, (nref + CHUNK - 1) / CHUNK), CHUNK, 0, (cudaStream_t)stream>>>(
      seg_off, seg_jref, seg_s, seg_e, Xref, nref, kold, ref_freq, dosage, x, voted);
  return (int)cudaGetLastError();
}
"""

WALK = "walk(slot[i], rows[i], tid, same, bound, st);"
NO_WALK = ((WALK, "(void)0;", 1),)
ROW_WORD = "const unsigned a = *reinterpret_cast<const unsigned*>(&rows[m][PER * u]);"
NO_COPIES = (("  if (lane == 0) bar_arrive_expect(bar, n * bytes);",
              "  if (lane == 0) bar_arrive_expect(bar, 0);", 1),
             ("  if (lane < n) copy_bulk(", "  if (false) copy_bulk(", 1),
             (ROW_WORD, "const unsigned a = 0x01000100u ^ (unsigned)m;", 2),
             ("if (rows[m][PER * u + i])", "if ((m ^ i) & 1)", 1))
NO_PACK = (("  int n = 0;\n  bool more = false;",
            "  if (lane == 0) {\n    sl.n = 0;\n    sl.more = 0;\n"
            "    sl.bound = 0.0;\n  }\n  __syncwarp();\n  return pos;\n"
            "  int n = 0;\n  bool more = false;", 1),)
BOUNDS = "__launch_bounds__(THREADS, 10)\nk5_vote("

# name -> ((text of csrc/impute_vote.cu, its replacement, times), ...), cut
VARIANTS = {
    "as_is": ((), False),
    "rows_16": ((("constexpr int ROWS = 32;", "constexpr int ROWS = 16;", 1),),
                False),
    "slots_3": ((("constexpr int SLOTS = 2;", "constexpr int SLOTS = 3;", 1),),
                False),
    "slots_4": ((("constexpr int SLOTS = 2;", "constexpr int SLOTS = 4;", 1),),
                False),
    "grid_skew": ((("const int t = (int)(blockIdx.x % nt), p = (int)(blockIdx.x / nt);",
                    "const int t = (int)(blockIdx.x % nt), p = (int)((blockIdx.x / nt + "
                    "blockIdx.x % nt) % ((chunks + span - 1) / span));", 1),), False),
    "stores_scalar": ((("  const bool whole = k + PER <= nref;",
                        "  const bool whole = false;", 1),), False),
    "min_blocks_1": (((BOUNDS, "__launch_bounds__(THREADS)\nk5_vote(", 1),),
                     False),
    "min_blocks_12": (((BOUNDS, "__launch_bounds__(THREADS, 12)\nk5_vote(", 1),),
                      False),
    "never_same": ((("    const bool same = st.ko[0] == st.ko[PER - 1];",
                     "    const bool same = false;", 1),), False),
    "f64_walk": ((("constexpr double EXACT_U32 = 4.0e9;",
                   "constexpr double EXACT_U32 = -1.0;", 1),), False),
    "always_divide": ((("sc == 0.0 ? 0.0 : sc == ss ? 1.0 :",
                        "sc == 0.0 ? __ddiv_rn(sc, ss) : sc == ss ? "
                        "__ddiv_rn(sc, ss) :", 1),), False),
    "prepass_only": ((("  k5_vote<<<", "  return (int)cudaGetLastError();\n"
                       "  k5_vote<<<", 1),), True),
    "no_walk": (NO_WALK, True),
    "no_copies": (NO_COPIES, True),
    "window_only": (NO_WALK + NO_COPIES, True),
    "stores_only": (NO_WALK + NO_COPIES + NO_PACK, True),
}


def say(tag, **kv):
    print(json.dumps({"probe": tag, **kv}), flush=True)


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def path_inputs(N):
    """(segments (n, 4) int64, kold (N,), Xref (Mref, N) uint8, ref_freq)
    of the imputation slice's recipe at N sites, made in memory."""
    import numpy as np
    import chip_smoke as cs
    from pbwt_tpu_torch.algos import impute as algo
    from pbwt_tpu_torch.core import registry
    from pbwt_tpu_torch.core.pbwt import PBWT, Site
    X = cs.ls_panel(cs.IMPUTE_MREF + cs.IMPUTE_T, N, switch=cs.IMPUTE_SWITCH)
    registry.init()
    vid = registry.variation("A", "C")
    sites = [Site(x=1_000 + 10 * k, varD=vid) for k in range(N)]
    with cs.device_env(None):
        p_ref = PBWT.from_haplotypes(np.ascontiguousarray(X[:cs.IMPUTE_MREF]),
                                     chrom="20", sites=sites)
        p_old = PBWT.from_haplotypes(
            np.ascontiguousarray(X[cs.IMPUTE_MREF:, ::cs.IMPUTE_STEP]),
            chrom="20", sites=sites[::cs.IMPUTE_STEP])
    p_frame = p_ref.select_sites(p_old.sites, keep_old=True)
    p_frame.build_reverse()
    p_old = p_old.select_sites_fill_missing(p_ref.sites, keep_old=False)
    segments = algo._collect_matches(p_frame, p_old)
    kold = algo._frame_coordinates(p_ref, p_frame)
    Xref = np.ascontiguousarray(X[:cs.IMPUTE_MREF])
    return segments, kold, Xref, Xref.mean(axis=0)


def covering_pairs(np, s, e, kold):
    return int(np.clip(np.searchsorted(kold, e) - np.searchsorted(
        kold, s, side="right"), 0, None).sum())


def count(sites):
    import numpy as np
    import chip_smoke as cs
    from pbwt_tpu_torch.ops import impute
    C = impute.CHUNK
    for N in sites:
        segments, kold, _, _ = path_inputs(N)
        T = cs.IMPUTE_T
        off, _, s, e = impute.segment_columns(segments, T)
        assert (np.diff(kold) >= 0).all()
        nch = -(-N // C)
        pad = np.concatenate([kold, np.full(nch * C - N, kold[-1])])
        clo, chi = pad.reshape(nch, C).min(1), pad.reshape(nch, C).max(1)
        # the chunks where a segment is packed: chi > s and clo < e
        first = np.searchsorted(chi, s, side="right")
        last = np.searchsorted(clo, e, side="left") - 1
        tg = np.repeat(np.arange(T), np.diff(off))
        on = first <= last
        diff = np.zeros((T, nch + 1), np.int64)
        np.add.at(diff, (tg[on], first[on]), 1)
        np.add.at(diff, (tg[on], last[on] + 1), -1)
        kept = np.cumsum(diff, axis=1)[:, :nch]
        say("count", M_ref=cs.IMPUTE_MREF, N=N, T=T, segments=len(s),
            covering_pairs=covering_pairs(np, s, e, kold),
            kept_mean=float(kept.mean()), kept_max=int(kept.max()),
            kept_p99=float(np.percentile(kept, 99)),
            chunks_over_a_slot=float((kept > ROWS).mean()),
            segments_a_target=float(len(s) / T))


def build(nvcc, kernels, tmp):
    """Each variant's and the old design's library, one nvcc each, all
    started together; and ptxas -v of the package's source."""
    base = open(os.path.join(kernels.CSRC, "impute_vote.cu")).read()
    srcs = {"old": OLD_SOURCE}
    for name, (edits, _) in VARIANTS.items():
        text = base
        for old, new, times in edits:
            if text.count(old) != times:
                sys.exit(f"variant {name}: {old!r} is no longer there "
                         f"{times} time(s)")
            text = text.replace(old, new)
        srcs[name] = text
    libs, procs = {}, []
    for name, text in srcs.items():
        src = os.path.join(tmp, f"{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        libs[name] = os.path.join(tmp, f"lib{name}.so")
        procs.append(subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
             libs[name], src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    for name, p in zip(srcs, procs):
        out = p.communicate()[0]
        if p.returncode:
            sys.exit(f"{name}: {out}")
        for part in out.split("Compiling entry function '")[1:]:
            fn = part.split("'", 1)[0]
            if "k5_vote" in fn:
                info = [ln.split(":", 1)[-1].strip() for ln in part.splitlines()
                        if "spill" in ln or "Used" in ln]
                say("ptxas", design=name, function=fn[-40:],
                    info="; ".join(info))
    return libs


def entry(lib, name):
    """The C entry of a built copy: k5_impute_vote, or the earlier design's
    k5_old."""
    from pbwt_tpu_torch.ops import kernels
    if name == "old":
        fn = ctypes.CDLL(lib).k5_old
        fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 4, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_int, *[ctypes.c_void_p] * 6]
    else:
        fn = ctypes.CDLL(lib).k5_impute_vote
        fn.argtypes = kernels._SIGNATURES["k5_impute_vote"]
    return fn


def runner(torch, fn, call):
    """A call of fn that must return 0, made once and synchronised."""
    def run():
        assert fn(*call) == 0
    run()
    torch.cuda.synchronize()
    return run


def probe(tmp):
    import numpy as np
    import torch
    import chip_smoke as cs
    from pbwt_tpu_torch.ops import impute, kernels
    if not torch.cuda.is_available():
        sys.exit("tools/k5_probe.py needs a CUDA card (or: count N)")
    libs = build(kernels.nvcc(), kernels, tmp)
    dev = torch.device("cuda", 0)
    card = card_name()
    T = cs.IMPUTE_T
    segments, kold, Xref, freq = path_inputs(cs.IMPUTE_NREF)
    off, jref, s, e, ko, fr = (torch.from_numpy(c).to(dev) for c in (
        *impute.segment_columns(segments, T), kold.astype(np.int32),
        np.asarray(freq, np.float64)))
    X = impute.pitched_rows(torch.from_numpy(Xref).to(dev))
    say("inputs", T=T, Mref=X.shape[0], Nref=X.shape[1],
        segments=jref.numel(), covering_pairs=covering_pairs(
            np, s.cpu().numpy(), e.cpu().numpy(), kold), card=card)

    def calls(name, X, ko, fr, span):
        """(the entry's arguments, out, window) at these rows and sites."""
        nref = X.shape[1]
        out = (torch.empty((T, nref), dtype=torch.float64, device=dev),
               *(torch.empty((T, nref), dtype=torch.uint8, device=dev)
                 for _ in range(2)))
        if name == "old":   # rows of stride nref
            return (dev.index, off.data_ptr(), jref.data_ptr(), s.data_ptr(),
                    e.data_ptr(), T, X.data_ptr(), nref, ko.data_ptr(),
                    fr.data_ptr(), *(o.data_ptr() for o in out),
                    kernels.stream(dev)), out, None
        window = impute.window_buffers(e, T, nref, span)
        return impute.k5_arguments(dev, off, jref, s, e, X, ko, fr, span,
                                   window, out), out, window

    args = (off, jref, s, e, X, ko, fr)
    want = impute.impute_vote_plain(*args)
    span = impute.span_chunks(X.shape[0])
    twin = impute.vote_window(off, e, ko, span)
    for name in ("old", *VARIANTS):
        call, out, window = calls(name, X, ko, fr, span)
        run = runner(torch, entry(libs[name], name), call)
        cut = name != "old" and VARIANTS[name][1]
        same = cs.vote_equal(torch, out, want)
        if not (same or cut):
            sys.exit(f"variant {name} differs from the twin")
        if name == "as_is" and not all(map(torch.equal, window[:2], twin)):
            sys.exit("K5's pre-pass differs from vote_window")
        say("variant", name=name, cut=cut, bits=same,
            ms=f"{cs.cuda_ms(torch, run, 10):.4f}", card=card)
    as_is = entry(libs["as_is"], "as_is")
    for sp in (4, 8, 16, 32):
        call, out, _ = calls("as_is", X, ko, fr, sp)
        run = runner(torch, as_is, call)
        if not cs.vote_equal(torch, out, want):
            sys.exit(f"K5 at a span of {sp} chunks differs from the twin")
        say("span", span_chunks=sp, slab_mb=X.shape[0] * sp * 256 / 1e6,
            wrapper_span=sp == span, ms=f"{cs.cuda_ms(torch, run, 10):.4f}",
            card=card)
    # the path's inputs without their last site: a site count that is not
    # a multiple of 16, in the pitch of reference_rows
    n = cs.IMPUTE_NREF - 1
    cut_args = (off, jref, s, e, X[:, :n], ko[:n].contiguous(),
                fr[:n].contiguous())
    want_cut = impute.impute_vote_plain(*cut_args)
    assert impute.pitched_rows(cut_args[4]).data_ptr() == X.data_ptr()
    times = {}
    for name, rows in (("as_is", cut_args[4]), ("old", X[:, :n].contiguous())):
        call, out, _ = calls(name, rows, *cut_args[5:], span)
        run = runner(torch, entry(libs[name], name), call)
        if not cs.vote_equal(torch, out, want_cut):
            sys.exit(f"{name} at {n} sites differs from the twin")
        times[f"{name}_ms"] = f"{cs.cuda_ms(torch, run, 10):.4f}"
    contiguous = (*cut_args[:4], X[:, :n].contiguous(), *cut_args[5:])
    check = impute.impute_vote(*contiguous)
    if not cs.vote_equal(torch, check, want_cut):
        sys.exit(f"impute_vote on contiguous rows of {n} differs from the twin")
    # the rows from site-major columns on the card, as reference_rows makes
    # them: into the pitch, and (the layout before the pitch) contiguous
    for m in (n, cs.IMPUTE_NREF):
        cols = torch.from_numpy(np.ascontiguousarray(Xref[:, :m].T)).to(dev)
        times[f"pitched_rows_of_columns_{m}_ms"] = f"{cs.cuda_ms(torch, lambda: impute.pitched_rows(cols.t()), 10):.4f}"
        times[f"contiguous_of_columns_{m}_ms"] = f"{cs.cuda_ms(torch, lambda: cols.t().contiguous(), 10):.4f}"
        del cols
    # ways to lay contiguous rows of n bytes out in the pitch
    rows = X[:, :n].contiguous()
    pad = torch.zeros((rows.shape[0], X.stride(0) - n), dtype=torch.uint8,
                      device=dev)
    for way, fn in (("copy", lambda: impute.pitched_rows(rows)),
                    ("cat", lambda: torch.cat([rows, pad], 1)),
                    ("pad", lambda: torch.nn.functional.pad(
                        rows, (0, X.stride(0) - n)))):
        times[f"pitch_by_{way}_ms"] = f"{cs.cuda_ms(torch, fn, 10):.4f}"
    del rows, pad
    say("nref", Nref=n, pitch=X.stride(0), covering_pairs=covering_pairs(
        np, s.cpu().numpy(), e.cpu().numpy(), kold[:n]), **times,
        wrapper_pitched_ms=f"{cs.cuda_ms(torch, lambda: impute.impute_vote(*cut_args), 10):.4f}",
        wrapper_contiguous_ms=f"{cs.cuda_ms(torch, lambda: impute.impute_vote(*contiguous), 10):.4f}",
        card=card)
    outs = tuple(torch.empty_like(w) for w in want)
    say("write_floor", bytes=sum(o.numel() * o.element_size() for o in outs),
        fill_ms=f"{cs.cuda_ms(torch, lambda: [o.fill_(1) for o in outs], 10):.4f}",
        card=card)
    say("wrapper", span_chunks=span,
        impute_vote_ms=f"{cs.cuda_ms(torch, lambda: impute.impute_vote(*args), 10):.4f}",
        vote_window_ms=f"{cs.cuda_ms(torch, lambda: impute.vote_window(off, e, ko, span), 10):.4f}",
        card=card)


def main():
    if sys.argv[1:2] == ["count"]:
        return count([int(n) for n in sys.argv[2:]] or [2_048])
    with tempfile.TemporaryDirectory(prefix="k5_probe_") as tmp:
        probe(tmp)


if __name__ == "__main__":
    main()
