// The weighted vote of reference imputation: kernel K5 of pbwt_tpu_torch.
//
// Replaces the XLA pass of pbwt_tpu/ops/impute_jax.py (_impute_chunk_scores,
// :31-55): per chunk of reference sites a row gather of the donors' alleles,
// the weights w = (k - s)(e - k) of every (segment, site) pair as an
// (nseg, chunk) f32 array, and each target's sums as the difference of two
// entries of a cumulative sum down the segment axis. That form suits a machine
// without cheap gathers or f64; its sums cancel, so its dosages are only close
// to the host's (pbwtImpute.c:1204-1232, the loop of native impute_vote_emit).
//
// Here every (target, reference site) sums its own covering segments, in
// segment order, with f64's results: the weights are integers, so the sums
// are exact below 2^53 and the quotient is the host's to the bit (__dmul_rn,
// __dadd_rn, __ddiv_rn). While a chunk's sums stay below 2^32 they are taken
// as unsigned integers, which is the same to the bit (walk_u32); past that the
// f64 additions go on one by one in segment order (walk_f64).
//
// A block takes one target and a span of consecutive chunks of CHUNK sites.
// A target's segments are sorted by start, so those that can weigh in a chunk
// (s below its largest frame coordinate, e above its least) lie in a run that
// moves forward with the chunk: it ends where the starts reach the chunk's
// largest coordinate, and every segment before the first whose running
// maximum of ends passes the least coordinate of the chunks still to come
// weighs nowhere in them. A pre-pass (k5_bounds, k5_window) finds each
// chunk's range of coordinates, makes that running maximum, a warp a target,
// and finds each (target, span)'s first segment by a binary search over it;
// the block then carries the run from chunk to chunk and never reads the
// segments before it again.
//
// In the block one producer warp reads the run 32 segments a step, packs those
// that weigh, in order, into a slot of ROWS, and has each packed segment's
// CHUNK allele bytes, Xref[j][k0 : k0 + CHUNK], copied into the slot by the
// copy engine (one bulk copy a row, cp.async.bulk, all issued before any wait;
// the rows' pitch is a multiple of 16 bytes, as bulk copies need, whatever nref
// is). A ring of SLOTS slots with an mbarrier each way (filled: the producer's
// lanes have written the slot and its bytes have landed; emptied: the consumers
// have walked it) lets the producer pack and copy the next slice while
// CONSUMERS warps walk this one. A chunk with more than ROWS segments that
// weigh takes several slices, in order. A consumer thread takes PER consecutive
// sites: it reads only shared memory, the packed (s, e) by broadcast and its
// sites' allele bytes as one word, and where its sites share a frame coordinate
// (eight sites a coordinate on a path typed at every 8th site) one weight
// serves them all. Its dosages go out as two 16-byte stores, its alleles and
// voted flags as a 4-byte store each; 0 / sum and sum / sum need no division.
//
// Bound on the H100: bytes. The function must read one allele byte a covering
// (segment, site) pair and write 10 bytes a (target, site): 8 of dosage, the
// allele and the voted flag; the four f64 operations a pair are far below the
// card's f64 rate. A span is as many chunks as keep the slab that the blocks
// running at one time read, Mref x span x CHUNK bytes, inside the 50 MB L2
// (the wrapper derives it from Mref); the target is the grid's fast axis.
// ops/impute.py: vote_window is the pre-pass's plain twin.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int CHUNK = 256;        // reference sites a chunk
constexpr int WARPS = CHUNK / 32;  // warps of the pre-pass's blocks
constexpr int PER = 4;            // consecutive sites a consumer thread
constexpr int CONSUMERS = CHUNK / PER / 32;    // consumer warps a block
constexpr int THREADS = (CONSUMERS + 1) * 32;  // and one producer warp
constexpr int ROWS = 32;          // segments a slot: one ballot of a warp
constexpr int SLOTS = 2;          // the ring of slots between producer and consumers
constexpr int SPAN_MAX = 32;      // chunks a block, at most
constexpr unsigned FULL = 0xffffffffu;

// one slot: a slice of a chunk's segments that weigh, in order
struct Slot {
  int2 se[ROWS];      // start, end
  int j[ROWS];        // donor row
  int n;              // segments in the slice
  int more;           // the chunk has more after this slice
  long long resume;   // where the next slice's scan starts
  double bound;       // above any weight sum the slice adds at a site
};

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem(bar))
               : "memory");
}

// an arrival on `bar` that also expects `bytes` of bulk copies to land
__device__ __forceinline__ void bar_arrive_expect(unsigned long long* bar, unsigned bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem(bar)),
      "r"(bytes)
      : "memory");
}

// one bulk copy (the copy engine, 16-byte multiples) that reports to `bar`
__device__ __forceinline__ void copy_bulk(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem(dst)),
      "l"(src), "r"(bytes), "r"(smem(bar))
      : "memory");
}

// The wait for a barrier's phase of this parity to complete. A wait that
// outlasts WAIT_CAP tries (seconds) traps, so that a fault fails the launch
// instead of hanging the card.
constexpr unsigned WAIT_CAP = 1u << 26;

__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == WAIT_CAP) __trap();
  }
}

// The producer warp: pack into `sl`, in order, the segments from `pos` on
// that weigh in the chunk of coordinates [lo, hi] (s < hi, e > lo), ROWS at
// most. With `find_next`, returns where the next chunk's scan may start: the
// first segment whose running maximum of ends passes `lnext` (the least
// coordinate of the chunks after this one), or a position before it.
__device__ long long pack_slot(Slot& sl, long long pos, long long end, int lo, int hi,
                               int lnext, bool find_next, const int* __restrict__ seg_jref,
                               const int* __restrict__ seg_s, const int* __restrict__ seg_e,
                               const int* __restrict__ seg_emax, int lane) {
  int n = 0;
  bool more = false;
  long long resume = pos, next = -1;
  unsigned reach = 0, first_s = 0;  // the most e - lo, and s of the first kept
  for (;; pos += 32) {
    const long long i = pos + lane;
    const bool valid = i < end;
    int s = INT_MAX, e = INT_MIN, j = 0, em = INT_MAX;
    if (valid) {
      s = seg_s[i];
      e = seg_e[i];
      j = seg_jref[i];
      em = seg_emax[i];
    }
    // the starts are sorted: the run ends at the first that reaches hi
    const unsigned stops = __ballot_sync(FULL, !valid || s >= hi);
    const unsigned before = stops ? (1u << (__ffs(stops) - 1)) - 1u : FULL;
    if (find_next && next < 0) {
      const unsigned past = __ballot_sync(FULL, valid && em > lnext) | stops;
      if (past) next = pos + __ffs(past) - 1;
    }
    unsigned keep = __ballot_sync(FULL, e > lo) & before;
    if (__popc(keep) > ROWS - n) {  // the slot is full: the rest go in the next slice
      unsigned rest = keep;
      for (int r = n; r < ROWS; ++r) rest &= rest - 1u;
      resume = pos + __ffs(rest) - 1;
      keep ^= rest;
      more = true;
    }
    const bool kept = (keep >> lane) & 1u;
    if (kept) {
      const int at = n + __popc(keep & ((1u << lane) - 1u));
      sl.se[at] = make_int2(s, e);
      sl.j[at] = j;
    }
    reach = max(reach, __reduce_max_sync(FULL, kept ? (unsigned)e - (unsigned)lo : 0u));
    if (n == 0 && keep) first_s = __shfl_sync(FULL, (unsigned)s, __ffs(keep) - 1);
    n += __popc(keep);
    if (more || stops) break;
  }
  if (lane == 0) {
    sl.n = n;
    sl.more = more;
    sl.resume = resume;
    // a weight at a site k of the chunk is (k - s)(e - k) <= (hi - s)(e - lo),
    // and the first kept segment has the least s
    sl.bound = n ? (double)n * (double)((unsigned)hi - first_s) * (double)reach : 0.0;
  }
  __syncwarp();
  return next >= 0 ? next : resume;
}

// The producer warp: the copies of the slot's rows, Xref[j][k0 : k0 + CHUNK]
// (cut at nref, rounded up to 16 bytes: the rows' pitch is a multiple of 16),
// into `rows`, a bulk copy a row, lane m row m, and the warp's arrival on the
// slot's barrier, told to expect their bytes.
__device__ __forceinline__ void issue_copies(const Slot& sl, unsigned char (*rows)[CHUNK],
                                             unsigned long long* bar,
                                             const unsigned char* __restrict__ Xref, int nref,
                                             int pitch, int k0, int lane) {
  const int n = sl.n, bytes = (min(CHUNK, nref - k0) + 15) & ~15;
  if (lane == 0) bar_arrive_expect(bar, n * bytes);
  __syncwarp();
  if (lane < n) copy_bulk(rows[lane], Xref + (size_t)sl.j[lane] * pitch + k0, bytes, bar);
  if (lane != 0) bar_arrive(bar);
}

// A consumer thread's PER sites: their frame coordinates, the weight sums
// and allele-weighted sums. While the sums stay below 2^32 (EXACT_U32; the
// slices' bounds say so for the whole chunk) they are added as unsigned
// integers: each f64 partial sum of the host's order is then an exact
// integer below 2^53, so the integer sum is the f64 sum to the bit, and a
// segment that does not weigh adds 0. Past it, the sums go on in f64 from
// where the integers stopped, one segment at a time (__dmul_rn, __dadd_rn).
struct Sites {
  int ko[PER];
  unsigned isum[PER], iscore[PER];
  double ssum[PER], score[PER];
};

constexpr double EXACT_U32 = 4.0e9;  // under 2^32 with room for the bound's rounding

// The integer regime over a slot. Sites of one frame coordinate (eight on a
// path typed at every 8th site) share a weight: where the thread's PER sites
// do, one weight a segment serves them all, and their sums of weights are
// one (isum[0], copied to the others when the chunk ends).
__device__ __forceinline__ void walk_u32(const Slot& sl, const unsigned char (*rows)[CHUNK],
                                         int u, bool same, Sites& st) {
  const int n = sl.n;
  if (same) {
    const int ko = st.ko[0];
#pragma unroll 2
    for (int m = 0; m < n; ++m) {
      const int2 se = sl.se[m];
      const unsigned w = (unsigned)max(ko - se.x, 0) * (unsigned)max(se.y - ko, 0);
      const unsigned a = *reinterpret_cast<const unsigned*>(&rows[m][PER * u]);
      st.isum[0] += w;
#pragma unroll
      for (int i = 0; i < PER; ++i) st.iscore[i] += w * ((a >> (8 * i)) & 0xffu);
    }
    return;
  }
  for (int m = 0; m < n; ++m) {
    const int2 se = sl.se[m];
    const unsigned a = *reinterpret_cast<const unsigned*>(&rows[m][PER * u]);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const unsigned w = (unsigned)max(st.ko[i] - se.x, 0) * (unsigned)max(se.y - st.ko[i], 0);
      st.isum[i] += w;
      st.iscore[i] += w * ((a >> (8 * i)) & 0xffu);
    }
  }
}

__device__ __forceinline__ void walk_f64(const Slot& sl, const unsigned char (*rows)[CHUNK], int u,
                                         Sites& st) {
  const int n = sl.n;
  for (int m = 0; m < n; ++m) {
    const int2 se = sl.se[m];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int ko = st.ko[i];
      if (se.x >= ko) continue;
      const double w = __dmul_rn((double)(ko - se.x), (double)(se.y - ko));
      if (w > 0.0) {
        st.ssum[i] = __dadd_rn(st.ssum[i], w);
        if (rows[m][PER * u + i]) st.score[i] = __dadd_rn(st.score[i], w);
      }
    }
  }
}

// A consumer thread: the slot's segments at its sites, in the integer regime
// while the chunk's bound so far allows it, else in f64.
__device__ __forceinline__ void walk(const Slot& sl, const unsigned char (*rows)[CHUNK], int u,
                                     bool same, double& bound, Sites& st) {
  const bool was_exact = bound < EXACT_U32;
  bound += sl.bound;
  if (bound < EXACT_U32) {
    walk_u32(sl, rows, u, same, st);
    return;
  }
  if (was_exact) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      st.ssum[i] = (double)(same ? st.isum[0] : st.isum[i]);
      st.score[i] = (double)st.iscore[i];
    }
  }
  walk_f64(sl, rows, u, st);
}

// A consumer thread: the dosage, allele and voted flag of its PER sites from
// k on; the dosages two 16-byte stores and the bytes a 4-byte store each
// where the addresses allow, else a store a site. 0 / ssum and ssum / ssum
// are exact: most sites take no division.
__device__ __forceinline__ void store_sites(double* __restrict__ dosage,
                                            unsigned char* __restrict__ x,
                                            unsigned char* __restrict__ voted,
                                            const double* __restrict__ ref_freq, size_t o, int k,
                                            int nref, const Sites& st) {
  double d[PER];
  unsigned xw = 0, vw = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const double ss = st.ssum[i], sc = st.score[i];
    d[i] = ss != 0.0 ? sc == 0.0 ? 0.0 : sc == ss ? 1.0 : __ddiv_rn(sc, ss)
           : k + i < nref ? ref_freq[k + i] : 0.0;
    xw |= (unsigned)(d[i] > 0.5) << (8 * i);
    vw |= (unsigned)(ss != 0.0) << (8 * i);
  }
  const bool whole = k + PER <= nref;
  if (whole && ((uintptr_t)(dosage + o) & 15) == 0) {
    reinterpret_cast<double2*>(dosage + o)[0] = make_double2(d[0], d[1]);
    reinterpret_cast<double2*>(dosage + o)[1] = make_double2(d[2], d[3]);
  } else {
    for (int i = 0; i < PER && k + i < nref; ++i) dosage[o + i] = d[i];
  }
  if (whole && ((uintptr_t)(x + o) & 3) == 0 && ((uintptr_t)(voted + o) & 3) == 0) {
    *reinterpret_cast<unsigned*>(x + o) = xw;
    *reinterpret_cast<unsigned*>(voted + o) = vw;
  } else {
    for (int i = 0; i < PER && k + i < nref; ++i) {
      x[o + i] = (xw >> (8 * i)) & 1u;
      voted[o + i] = (vw >> (8 * i)) & 1u;
    }
  }
}

// A consumer thread: the frame coordinates of its PER sites from k (a dead
// site past nref takes the coordinate before it; nothing of it is stored).
__device__ __forceinline__ void load_sites(const int* __restrict__ kold, int k, int nref,
                                           int* ko) {
#pragma unroll
  for (int i = 0; i < PER; ++i) ko[i] = k + i < nref ? kold[k + i] : i ? ko[i - 1] : 0;
}

__global__ void __launch_bounds__(THREADS, 10)
k5_vote(const long long* __restrict__ seg_off, const int* __restrict__ seg_jref,
        const int* __restrict__ seg_s, const int* __restrict__ seg_e,
        const int* __restrict__ seg_emax, const long long* __restrict__ span_first,
        const int* __restrict__ chunk_lo, const int* __restrict__ chunk_hi, int span, int nt,
        const unsigned char* __restrict__ Xref, int nref, int pitch,
        const int* __restrict__ kold, const double* __restrict__ ref_freq,
        double* __restrict__ dosage, unsigned char* __restrict__ x,
        unsigned char* __restrict__ voted) {
  __shared__ __align__(128) unsigned char rows[SLOTS][ROWS][CHUNK];
  __shared__ Slot slot[SLOTS];
  __shared__ unsigned long long filled[SLOTS], emptied[SLOTS];
  __shared__ int clo[SPAN_MAX], chi[SPAN_MAX], lsuf[SPAN_MAX + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = (nref + CHUNK - 1) / CHUNK;
  const int t = (int)(blockIdx.x % nt), p = (int)(blockIdx.x / nt);
  const int c0 = p * span, nch = min(span, chunks - c0);

  // each chunk's range of frame coordinates [clo, chi], and lsuf[c], the
  // least coordinate of chunks c.. of the span; the slots' barriers: a slot
  // is filled when the producer's 32 lanes have written it and its rows have
  // landed, emptied when the CONSUMERS warps have walked it
  if (tid < nch) {
    clo[tid] = chunk_lo[c0 + tid];
    chi[tid] = chunk_hi[c0 + tid];
  }
  if (tid < SLOTS) {
    bar_init(&filled[tid], 32);
    bar_init(&emptied[tid], CONSUMERS);
  }
  __syncthreads();
  if (tid == 0) {
    lsuf[nch] = INT_MAX;
    for (int c = nch - 1; c >= 0; --c) lsuf[c] = min(lsuf[c + 1], clo[c]);
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // the producer: each chunk's segments that weigh, a slice a slot, and
    // their alleles' copies, up to SLOTS slices ahead of the consumers
    const long long end = seg_off[t + 1];
    long long scan = span_first[(long long)p * nt + t];
    unsigned q = 0;  // slices made
    for (int c = 0; c < nch; ++c) {
      long long pos = scan;
      for (bool first = true;; first = false, ++q) {
        const int i = q % SLOTS;
        if (q >= SLOTS) bar_wait(&emptied[i], (q / SLOTS - 1) & 1);
        const long long next = pack_slot(slot[i], pos, end, clo[c], chi[c], lsuf[c + 1], first,
                                         seg_jref, seg_s, seg_e, seg_emax, lane);
        if (first) scan = next;
        issue_copies(slot[i], rows[i], &filled[i], Xref, nref, pitch, (c0 + c) * CHUNK, lane);
        if (!slot[i].more) {
          ++q;
          break;
        }
        pos = slot[i].resume;
      }
    }
    return;
  }

  // the consumers: a thread PER sites, each chunk's slices in order, then
  // their dosages, alleles and voted flags
  unsigned q = 0;  // slices walked
  int k = c0 * CHUNK + PER * tid;
  int ko_n[PER];
  Sites st;
  load_sites(kold, k, nref, st.ko);
  for (int c = 0; c < nch; ++c) {
    // the next chunk's coordinates, loaded ahead
    load_sites(kold, c + 1 < nch ? k + CHUNK : nref, nref, ko_n);
    const bool same = st.ko[0] == st.ko[PER - 1];
    double bound = 0.0;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      st.isum[i] = st.iscore[i] = 0;
      st.ssum[i] = st.score[i] = 0.0;
    }
    for (;; ++q) {
      const int i = q % SLOTS;
      bar_wait(&filled[i], (q / SLOTS) & 1);
      walk(slot[i], rows[i], tid, same, bound, st);
      const bool more = slot[i].more;
      __syncwarp();
      if (lane == 0) bar_arrive(&emptied[i]);
      if (!more) {
        ++q;
        break;
      }
    }
    if (bound < EXACT_U32) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        st.ssum[i] = (double)(same ? st.isum[0] : st.isum[i]);
        st.score[i] = (double)st.iscore[i];
      }
    }
    store_sites(dosage, x, voted, ref_freq, (size_t)t * nref + k, k, nref, st);
    k += CHUNK;
#pragma unroll
    for (int i = 0; i < PER; ++i) st.ko[i] = ko_n[i];
  }
}

// The pre-pass, a block a span: each chunk's least and largest frame
// coordinate, and the span's least.
__global__ void __launch_bounds__(CHUNK)
k5_bounds(const int* __restrict__ kold, int nref, int span, int* __restrict__ chunk_lo,
          int* __restrict__ chunk_hi, int* __restrict__ least) {
  __shared__ int part_lo[WARPS], part_hi[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunks = (nref + CHUNK - 1) / CHUNK, c0 = blockIdx.x * span;
  int span_lo = INT_MAX;
  for (int c = c0; c < min(c0 + span, chunks); ++c) {
    const int k = c * CHUNK + tid;
    int lo = k < nref ? kold[k] : INT_MAX, hi = k < nref ? kold[k] : INT_MIN;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(FULL, lo, off));
      hi = max(hi, __shfl_xor_sync(FULL, hi, off));
    }
    if (lane == 0) {
      part_lo[warp] = lo;
      part_hi[warp] = hi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < WARPS; ++w) {
        lo = min(lo, part_lo[w]);
        hi = max(hi, part_hi[w]);
      }
      chunk_lo[c] = lo;
      chunk_hi[c] = hi;
      span_lo = min(span_lo, lo);
    }
    __syncthreads();
  }
  if (tid == 0) least[blockIdx.x] = span_lo;
}

// The pre-pass, a warp a target: the running maximum of its segments' ends
// (a warp scan 32 at a time), then, a lane a span, the first segment whose
// running maximum exceeds the span's least coordinate (a binary search).
__global__ void __launch_bounds__(CHUNK)
k5_window(const long long* __restrict__ seg_off, const int* __restrict__ seg_e, int nt,
          const int* __restrict__ least, int spans, int* __restrict__ seg_emax,
          long long* __restrict__ span_first) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (t >= nt) return;
  const long long beg = seg_off[t], end = seg_off[t + 1];
  int carry = INT_MIN;
  for (long long base = beg; base < end; base += 32) {
    const long long i = base + lane;
    int v = i < end ? seg_e[i] : INT_MIN;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v = max(v, u);
    }
    v = max(v, carry);
    if (i < end) seg_emax[i] = v;
    carry = __shfl_sync(FULL, v, 31);
  }
  __syncwarp();
  for (int p = lane; p < spans; p += 32) {
    const int lo = least[p];
    long long a = beg, b = end;
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (seg_emax[mid] > lo)
        b = mid;
      else
        a = mid + 1;
    }
    span_first[(long long)p * nt + t] = a;
  }
}

}  // namespace

extern "C" {

// K5. seg_off (nt + 1,) int64 offsets of each target's segments; seg_jref,
// seg_s, seg_e int32 donor, start and end (frame coordinates) of each segment,
// sorted by (target, start); Xref (mref, nref) uint8 donor alleles in natural
// order, 16-byte aligned, in rows of `pitch` bytes, a multiple of 16 (the bytes
// past nref are read and not used); kold (nref,) int32 the frame coordinate of
// each reference site; ref_freq (nref,) f64; span the chunks of 256 sites a
// block, 1..32. Writes dosage (nt, nref) f64 = score / sum of the weights
// (kold - s)(e - kold) > 0 over the target's segments with s < kold, or
// ref_freq where none weighs; x = dosage > 0.5; voted = some segment weighs. On the way,
// the pre-pass writes seg_emax (nseg,) int32, the running maximum of the ends
// within each target; span_first (spans, nt) int64, the first segment of target
// t whose seg_emax exceeds span p's least kold (seg_off[t + 1] if none); and
// bounds (spans + 2 chunks,) int32, each span's least kold, then each chunk's
// least and largest; spans = ceil(chunks / span), chunks = ceil(nref / 256).
int k5_impute_vote(int device, const long long* seg_off, const int* seg_jref, const int* seg_s,
                   const int* seg_e, int nt, const unsigned char* Xref, int nref, int pitch,
                   const int* kold, const double* ref_freq, int span, int* seg_emax,
                   long long* span_first, int* bounds, double* dosage, unsigned char* x,
                   unsigned char* voted, void* stream) {
  if (nt <= 0 || nref <= 0) return 0;
  if (span < 1 || span > SPAN_MAX || pitch < nref || pitch % 16 || (uintptr_t)Xref % 16)
    return (int)cudaErrorInvalidValue;
  const int chunks = (nref + CHUNK - 1) / CHUNK;
  const long long spans = (chunks + span - 1) / span;
  if (spans * nt > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  int *least = bounds, *chunk_lo = bounds + spans, *chunk_hi = chunk_lo + chunks;
  k5_bounds<<<(unsigned)spans, CHUNK, 0, s>>>(kold, nref, span, chunk_lo, chunk_hi, least);
  k5_window<<<(nt + WARPS - 1) / WARPS, CHUNK, 0, s>>>(seg_off, seg_e, nt, least, (int)spans,
                                                       seg_emax, span_first);
  k5_vote<<<(unsigned)(spans * nt), THREADS, 0, s>>>(seg_off, seg_jref, seg_s, seg_e, seg_emax,
                                                    span_first, chunk_lo, chunk_hi, span, nt, Xref,
                                                    nref, pitch, kold, ref_freq, dosage, x, voted);
  return (int)cudaGetLastError();
}

// The kernel's layout for the wrapper's check: 1 sites a chunk, 2 most chunks
// a span.
int k5_layout(int what) { return what == 1 ? CHUNK : what == 2 ? SPAN_MAX : -1; }

}  // extern "C"
