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
// Here one warp paints one recipient individual and walks its haplotypes' sites
// in the host's order, so that every cell of the four tables receives its
// addends in the host's order and rounding: haplotype ascending, site k = 1 ..
// N-1, then segment in report order (ascending end). Each lane owns the donor
// individuals j with j % 32 == lane: it alone adds into their cells, and into
// the haplotype's running region sums part[j], which live in shared memory
// (8 B an individual). The window of site k is [m1, stop): m1 advances as the
// host's while loop does (a region closes at every chunksperregion-th advance
// and the lanes flush every column), stop is the first segment from m1 whose
// start is >= k; both only grow with k. The window's segments sit a lane each;
// the normaliser is their weights summed in window order through shuffles, the
// quotients are taken by all lanes at once, then handed to their owners in
// window order. Rounding: products and sums are rounded one by one (__dmul_rn,
// __dadd_rn, __ddiv_rn) and the region squares are one fused multiply-add
// (__fma_rn), as the host runtime computes them (csrc/pbwt_native.c:
// paint_accumulate), so the tables are the host's bit for bit.
//
// Bound on the H100: f64 operations. A covering (segment, site) pair costs a
// product, a sum, two divisions and three sums, against 8 B a table cell
// written once; a warp walks its sites one after another, so the kernel runs
// far above that bound (latency of the ordered sums and of each owner's
// read-modify-write of its cells).

#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(LANES)
k6_paint(const long long* __restrict__ seg_off, const int* __restrict__ sj,
         const int* __restrict__ ss, const int* __restrict__ se, int N, int ploidy,
         int cpr, int n_inds, double* __restrict__ counts, double* __restrict__ totlengths,
         double* __restrict__ counts2, double* __restrict__ counts3,
         double* __restrict__ nregions) {
  extern __shared__ double part[];  // the haplotype's open region, an individual each
  const int lane = threadIdx.x;
  const int me = blockIdx.x;
  const size_t row = (size_t)me * n_inds;
  double* cnt = counts + row;
  double* tl = totlengths + row;
  double* cnt2 = counts2 + row;
  double* cnt3 = counts3 + row;
  double nreg = 0.0;
  for (int h = 0; h < ploidy; ++h) {
    const int i = me * ploidy + h;
    const long long lo = seg_off[i], hi = seg_off[i + 1];
    if (lo >= hi) continue;
    for (int j = lane; j < n_inds; j += LANES) part[j] = 0.0;
    const long long m_stop = hi - 1;
    long long m1 = lo, n1 = 1, stop = lo;
    // segment base + lane: start, end, donor individual
    long long base = -1;
    int cs = 0, ce = 0, cind = 0;
    for (int k = 1; k < N; ++k) {
      while (m1 < m_stop) {
        const int e1 = (base >= 0 && m1 - base < LANES)
                           ? __shfl_sync(FULL, ce, (int)(m1 - base))
                           : __ldg(se + m1);
        if (e1 > k) break;
        if (n1 % cpr == 0) {  // a region closes: every column but the recipient's
          for (int j = lane; j < n_inds; j += LANES) {
            if (j == me) continue;
            const double pj = part[j];
            cnt2[j] = __fma_rn(pj, pj, cnt2[j]);
            cnt3[j] = __dadd_rn(cnt3[j], pj);
            part[j] = 0.0;
          }
          nreg += 1.0;  // part[me] receives nothing, so it stays 0
        }
        ++m1;
        ++n1;
      }
      if (base != m1) {
        base = m1;
        const long long m = base + lane;
        if (m <= m_stop) {
          cs = __ldg(ss + m);
          ce = __ldg(se + m);
          cind = __ldg(sj + m) / ploidy;
        }
      }
      if (stop < m1) stop = m1;
      while (stop <= m_stop) {
        const int s_at = stop - base < LANES ? __shfl_sync(FULL, cs, (int)(stop - base))
                                             : __ldg(ss + stop);
        if (s_at >= k) break;
        ++stop;
      }
      if (stop == m1) continue;  // an empty window sums to 0

      // the normaliser: the window's weights in window order
      double ssum = 0.0;
      for (long long c0 = m1; c0 < stop; c0 += LANES) {
        const long long m = c0 + lane;
        int s = cs, e = ce, ind = cind;
        if (c0 != base && m < stop) {
          s = __ldg(ss + m);
          e = __ldg(se + m);
          ind = __ldg(sj + m) / ploidy;
        }
        const double w = (m < stop && ind != me)
                             ? __dmul_rn((double)(k - s), (double)(e - k)) : 0.0;
        const int n = (int)min((long long)LANES, stop - c0);
        for (int t = 0; t < n; ++t) ssum = __dadd_rn(ssum, __shfl_sync(FULL, w, t));
      }
      if (ssum == 0.0) continue;

      // the quotients, all lanes at once; each owner adds them in window order
      for (long long c0 = m1; c0 < stop; c0 += LANES) {
        const long long m = c0 + lane;
        int s = cs, e = ce, ind = cind;
        if (c0 != base && m < stop) {
          s = __ldg(ss + m);
          e = __ldg(se + m);
          ind = __ldg(sj + m) / ploidy;
        }
        double w = 0.0, tc = 0.0;
        if (m < stop && ind != me) {
          w = __ddiv_rn(__dmul_rn((double)(k - s), (double)(e - k)), ssum);
          tc = __ddiv_rn(w, (double)(e - s));
        } else {
          ind = -1;
        }
        const int n = (int)min((long long)LANES, stop - c0);
        for (int t = 0; t < n; ++t) {
          const int it = __shfl_sync(FULL, ind, t);
          const double wt = __shfl_sync(FULL, w, t);
          const double ct = __shfl_sync(FULL, tc, t);
          if (it >= 0 && (it & (LANES - 1)) == lane) {
            tl[it] = __dadd_rn(tl[it], wt);
            cnt[it] = __dadd_rn(cnt[it], ct);
            part[it] = __dadd_rn(part[it], ct);
          }
        }
      }
    }
  }
  if (lane == 0) nregions[me] = nreg;
}

}  // namespace

extern "C" {

// K6. seg_off (m + 1,) int64 offsets of each recipient haplotype's segments;
// sj, ss, se int32 donor haplotype, start and end of each segment, a
// recipient's in report order (ascending end); m haplotypes of n sites, ploidy
// of them an individual; a region closes every cpr-th advance of the window.
// Writes counts, totlengths, counts2, counts3 (m / ploidy, m / ploidy) f64 and
// nregions (m / ploidy,) f64, which must hold zeros: what native
// paint_accumulate writes with cutoff < 0.
int k6_paint_accumulate(int device, const long long* seg_off, const int* sj, const int* ss,
                        const int* se, int m, int n, int ploidy, int cpr, double* counts,
                        double* totlengths, double* counts2, double* counts3,
                        double* nregions, void* stream) {
  if (ploidy <= 0 || cpr <= 0) return (int)cudaErrorInvalidValue;
  const int n_inds = m / ploidy;
  if (n_inds <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)n_inds * sizeof(double);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(k6_paint, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  k6_paint<<<n_inds, LANES, smem, (cudaStream_t)stream>>>(
      seg_off, sj, ss, se, n, ploidy, cpr, n_inds, counts, totlengths, counts2, counts3,
      nregions);
  return (int)cudaGetLastError();
}

}  // extern "C"
