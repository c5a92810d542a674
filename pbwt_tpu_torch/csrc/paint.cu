// Painting's co-ancestry accumulation: kernel K6 of pbwt_tpu_torch.
//
// Replaces the XLA pass of pbwt_tpu/ops/paint_jax.py (_paint_chunk, :24-81,
// driven by paint_totals_device, :84-172): per chunk of sites an (nseg, chunk)
// f32 grid of the weights (k - s)(e - k), a segmented running max for the
// reference's window rule, per-recipient normalisers by segment_sum and 64-site
// sub-block sums, with the region tables rebuilt on the host from prefix sums
// requested at the region-closing sites. That form suits a machine that is
// parallel over sites and has no cheap f64; its tables are only f32-close to
// the host's (pbwtPaint.c:56-209, native paint_accumulate), so the JAX route is
// off by default.
//
// Here the tables are the host's bit for bit, and the work is parallel over
// table cells. Of the host's loop (csrc/pbwt_native.c: paint_accumulate) only
// the sums into one cell (recipient individual, donor individual) are
// ordered: the normaliser of a (haplotype, site) is a sum of integers, exact
// in f64 in any order, and each quotient is a fixed two-step rounding. The
// wrapper (ops/paint.py: prepare) turns the segments into intervals of sites
// [a, b) at which each is weighed, bucketed by cell in (haplotype, segment)
// order, and lists each haplotype's region closes. Then, in one entry:
//   * phase 1 (k6_norm), a block a haplotype: the normaliser of each site,
//     sum over the window of (k - s)(e - k) = -k^2 + (s + e)k - se, from three
//     int64 difference arrays (count, s + e, se) in shared memory, 512 sites
//     at a time, and a block scan; stored as f64 (exact below 2^53) in an
//     (M, N) scratch;
//   * phase 2 (k6_cells), a thread a cell: h ascending; within h, k ascending
//     over the union of the cell's intervals; at a site, segment ascending.
//     A haplotype's intervals end in order and those in the window at a site
//     are a run, so two pointers [p, q) give the cell's run at each site. At
//     each pair w = (k - s)(e - k) / ssum and w / (e - s) are added to the
//     chunk length, the chunk count and the open region; a region close
//     between two of the cell's additions (or after its last in h) flushes the
//     region. The four sums live in registers and are stored once. The cells
//     are scheduled by the power of two of their pairs, largest first, so the
//     longest chains start first and a warp's lanes carry like work.
// Rounding: products, sums and quotients one by one (__dmul_rn, __dadd_rn,
// __ddiv_rn), the region squares one fused multiply-add (__fma_rn), as the
// host runtime computes them.
//
// Bound on the H100: f64 operations. A weighed (segment, site) pair costs a
// product, its share of the normaliser, two correctly rounded divisions and
// three sums. A division is no single instruction on sm_90a: a reciprocal seed
// (MUFU.RCP64H) and a Newton sequence of DFMAs with a range test, 12
// DFMA-equivalents as tools/k6_probe.py counts them in the built code, so the
// bound counts 29 f64 operations a pair. What holds K6 above it (PERF.md,
// section 6): the walk's dependent loads (the next interval, a close, the
// normaliser of each site), which a warp's lanes meet at different sites, and
// the wrapper's preparation in torch.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int NORM_THREADS = 128;
constexpr int NORM_SITES = 512;                       // sites a pass of a block
constexpr int NORM_PER = NORM_SITES / NORM_THREADS;   // consecutive sites a thread
constexpr int CELL_THREADS = 128;

// Phase 1: block h sums the normalisers of haplotype h, a pass of NORM_SITES
// sites [c0, c1) at a time. An interval (a, b, s, e) adds (1, s + e, se) at a
// and takes it off at b; the inclusive prefix (C, A, B) at site k, carried
// from pass to pass, gives sum (k - s)(e - k) = -C k^2 + A k - B over the
// intervals that cover k. Intervals end in order, so those that end within a
// pass are a prefix of the rest and are skipped for good after it; and those
// that start after the pass are a suffix of the rest (the intervals at a site
// are a run: the host's window), so a thread stops at the first it meets.
__global__ void __launch_bounds__(NORM_THREADS)
k6_norm(const long long* __restrict__ hap_off, const int4* __restrict__ hap_iv, int N,
        double* __restrict__ ssum) {
  __shared__ unsigned long long d[3][NORM_SITES];
  __shared__ long long wsum[3][NORM_THREADS / 32];
  __shared__ int ended;  // intervals that end within the pass
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int h = blockIdx.x;
  const long long hi = hap_off[h + 1];
  long long lo = hap_off[h];
  double* row = ssum + (size_t)h * N;
  long long carry[3] = {0, 0, 0};
  for (int c0 = 0; c0 < N; c0 += NORM_SITES) {
    const int c1 = c0 + NORM_SITES;
    for (int i = t; i < 3 * NORM_SITES; i += NORM_THREADS) (&d[0][0])[i] = 0;
    if (t == 0) ended = 0;
    __syncthreads();
    for (long long r = lo + t; r < hi; r += NORM_THREADS) {  // lo: the first to end at c0 or later
      const int4 v = __ldg(hap_iv + r);  // a, b, start, end
      const int a = v.x, b = v.y, s = v.z, e = v.w;
      if (a >= c1) break;
      const unsigned long long se = (unsigned long long)((long long)s * e);
      const unsigned long long sp = (unsigned long long)((long long)s + e);
      if (a >= c0) {
        atomicAdd(&d[0][a - c0], 1ull);
        atomicAdd(&d[1][a - c0], sp);
        atomicAdd(&d[2][a - c0], se);
      }
      if (b < c1) {
        atomicAdd(&ended, 1);
        atomicAdd(&d[0][b - c0], ~0ull);  // -1
        atomicAdd(&d[1][b - c0], 0ull - sp);
        atomicAdd(&d[2][b - c0], 0ull - se);
      }
    }
    __syncthreads();
    // inclusive scan: a thread's NORM_PER sites, then the warp, then the block
    long long run[3][NORM_PER], tot[3];
    for (int c = 0; c < 3; ++c) {
      long long x = 0;
#pragma unroll
      for (int i = 0; i < NORM_PER; ++i) {
        x += (long long)d[c][t * NORM_PER + i];
        run[c][i] = x;
      }
      tot[c] = x;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, tot[c], o);
        if (lane >= o) tot[c] += y;
      }
      if (lane == 31) wsum[c][warp] = tot[c];
      tot[c] -= x;  // the warp's sum before this thread
    }
    __syncthreads();
    for (int c = 0; c < 3; ++c) {
      long long before = carry[c];
      for (int w = 0; w < NORM_THREADS / 32; ++w) {
        if (w < warp) before += wsum[c][w];
        carry[c] += wsum[c][w];
      }
      tot[c] += before;
    }
    lo += ended;
    __syncthreads();  // every thread has read d, wsum and ended
    double* out = reinterpret_cast<double*>(&d[0][0]);
#pragma unroll
    for (int i = 0; i < NORM_PER; ++i) {
      const long long k = c0 + t * NORM_PER + i;
      const long long C = tot[0] + run[0][i], A = tot[1] + run[1][i], B = tot[2] + run[2][i];
      out[t * NORM_PER + i] = (double)(-C * k * k + A * k - B);
    }
    __syncthreads();
    for (int i = t; i < NORM_SITES && c0 + i < N; i += NORM_THREADS) row[c0 + i] = out[i];
    __syncthreads();
  }
}

// The first index in [lo, hi) whose close site is past k (sites ascending):
// a few steps, then a binary search.
__device__ __forceinline__ long long past(const int* __restrict__ site, long long lo,
                                          long long hi, int k) {
  for (int n = 0; n < 4; ++n) {
    if (lo == hi || __ldg(site + lo) > k) return lo;
    ++lo;
  }
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(site + mid) <= k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// A region close: the open region's square and sum go to the cell. Every
// addend of a region is > 0 (a live weight is positive, and a tail window holds
// one segment, whose w is 1), so part == 0 only when nothing was added since
// the last flush, and a flush of 0 (fma(0, 0, c2) = c2, c3 + 0 = c3) changes
// nothing: it is skipped.
__device__ __forceinline__ void flush(double& part, double& c2, double& c3) {
  if (part != 0.0) {
    c2 = __fma_rn(part, part, c2);
    c3 = __dadd_rn(c3, part);
    part = 0.0;
  }
}

// Phase 2: thread t walks cell sched[t] and stores its four sums once. A
// haplotype's intervals [i, j) end in order and those in the window at a site
// are a run of them, so two pointers give the run [p, q) that covers site k:
// p the first that ends after k, q the first from p that starts after k.
__global__ void __launch_bounds__(CELL_THREADS)
k6_cells(long long ncells, const int* __restrict__ sched,
         const long long* __restrict__ cell_off, const long long* __restrict__ cell_key,
         const int4* __restrict__ cell_iv, const int* __restrict__ cell_hap,
         const long long* __restrict__ close_off, const int* __restrict__ close_site,
         const double* __restrict__ ssum, int N, double* __restrict__ counts,
         double* __restrict__ totlengths, double* __restrict__ counts2,
         double* __restrict__ counts3) {
  const long long t = (long long)blockIdx.x * CELL_THREADS + threadIdx.x;
  if (t >= ncells) return;
  const int c = __ldg(sched + t);
  long long i = __ldg(cell_off + c);
  const long long end = __ldg(cell_off + c + 1);
  double tl = 0.0, cnt = 0.0, c2 = 0.0, c3 = 0.0;
  while (i < end) {  // a haplotype's intervals [i, j)
    const int h = __ldg(cell_hap + i);
    long long j = i + 1;
    while (j < end && __ldg(cell_hap + j) == h) ++j;
    const double* row = ssum + (size_t)h * N;
    const long long cend = __ldg(close_off + h + 1);
    // the walk keeps in registers the interval at p (v: its end is the
    // first to come), the start of the one at q (qa) and the next close
    // site (cs), and loads one of them again only when its pointer moves
    int4 v = __ldg(cell_iv + i);
    int k = v.x, qa = v.x;
    // closes up to the first site find the region empty
    long long cp = past(close_site, __ldg(close_off + h), cend, k);
    int cs = cp < cend ? __ldg(close_site + cp) : INT_MAX;
    long long p = i, q = i;
    double part = 0.0;
    for (;;) {
      while (qa <= k) {
        ++q;
        qa = q < j ? __ldg(&cell_iv[q].x) : INT_MAX;
      }
      const double z = __ldg(row + k);
      if (z != 0.0) {  // the host skips a site whose window sums to 0
        if (q - p == 1) {
          const double w = __ddiv_rn(__dmul_rn((double)(k - v.z), (double)(v.w - k)), z);
          const double tc = __ddiv_rn(w, (double)(v.w - v.z));
          tl = __dadd_rn(tl, w);
          cnt = __dadd_rn(cnt, tc);
          part = __dadd_rn(part, tc);
        } else {
          for (long long r = p; r < q; ++r) {
            const int4 u = __ldg(cell_iv + r);  // a, b, start, end
            const double w = __ddiv_rn(__dmul_rn((double)(k - u.z), (double)(u.w - k)), z);
            const double tc = __ddiv_rn(w, (double)(u.w - u.z));
            tl = __dadd_rn(tl, w);
            cnt = __dadd_rn(cnt, tc);
            part = __dadd_rn(part, tc);
          }
        }
      }
      int nk = k + 1;
      while (v.y <= nk && ++p < j) v = __ldg(cell_iv + p);
      if (p == j) break;
      if (q < p) {
        q = p;
        qa = v.x;
      }
      if (q == p) nk = max(nk, v.x);  // nothing covers k + 1
      if (cs <= nk) {  // a close before nk's additions
        flush(part, c2, c3);
        cp = past(close_site, cp, cend, nk);
        cs = cp < cend ? __ldg(close_site + cp) : INT_MAX;
      }
      k = nk;
    }
    if (cp < cend) flush(part, c2, c3);  // a close after the last addition
    i = j;
  }
  const long long key = __ldg(cell_key + c);
  counts[key] = cnt;
  totlengths[key] = tl;
  counts2[key] = c2;
  counts3[key] = c3;
}

}  // namespace

extern "C" {

// K6. m haplotypes of n sites; phases 1 (normalisers), 2 (cells) or 3 (both).
// From ops/paint.py:prepare: hap_off (m + 1,) int64 and hap_iv (niv, 4) int32
// {a, b, start, end}, each haplotype's intervals in segment order; sched
// (ncells,) int32; cell_off (ncells + 1,) int64 and cell_key (ncells,) int64
// (recipient individual * n_inds + donor individual); cell_iv (niv, 4) and
// cell_hap (niv,) int32, the intervals in cell order and their haplotypes;
// close_off (m + 1,) int64 and close_site int32, each haplotype's close sites,
// ascending. ssum (m, n) f64 scratch; counts, totlengths, counts2, counts3
// (n_inds, n_inds) f64 holding zeros. What native paint_accumulate writes
// with cutoff < 0, but nregions.
int k6_paint_accumulate(int device, int m, int n, int phases, const long long* hap_off,
                        const int* hap_iv, long long ncells, const int* sched,
                        const long long* cell_off, const long long* cell_key,
                        const int* cell_iv, const int* cell_hap, const long long* close_off,
                        const int* close_site, double* ssum, double* counts,
                        double* totlengths, double* counts2, double* counts3, void* stream) {
  if (m < 0 || n < 0 || ncells < 0 || phases < 1 || phases > 3)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if ((phases & 1) && m > 0 && n > 0) {
    k6_norm<<<m, NORM_THREADS, 0, s>>>(hap_off, reinterpret_cast<const int4*>(hap_iv), n,
                                       ssum);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if ((phases & 2) && ncells > 0) {
    const long long blocks = (ncells + CELL_THREADS - 1) / CELL_THREADS;
    k6_cells<<<(unsigned)blocks, CELL_THREADS, 0, s>>>(
        ncells, sched, cell_off, cell_key, reinterpret_cast<const int4*>(cell_iv), cell_hap,
        close_off, close_site, ssum, n, counts, totlengths, counts2, counts3);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // extern "C"
