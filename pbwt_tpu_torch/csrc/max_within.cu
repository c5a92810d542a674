// Set-maximal matches within a panel on the card: kernel K9 k9_max_within of
// pbwt_tpu_torch, painting's collection of each haplotype's matches.
//
// Replaces no TPU kernel: the JAX package collects them on the host
// (pbwt_tpu/algos/paint.py:_collect_match_arrays, the C runtime's
// max_within_bucketed), as the port did before: two passes of algorithm 4
// (Durbin 2014; max_within_impl in csrc/pbwt_native.c) over the pack3 bytes
// on one thread, a counting pass and a pass that places (donor, start, end)
// into per-recipient buckets. There the scan at a site needs the prefix and
// divergence arrays before it, which the C loop carries from site to site.
// Here K2's entry k2_partition_ad_table writes them for every site as rows of
// two tables (A, D) from the columns that k1_decode_columns decoded, and the
// scan is parallel over every (site, sort position) at once.
//
// A thread a (site k, position i) applies max_within_impl's rule exactly: the
// divergence sentinels at 0 and m are k + 1; where d[i] <= d[i+1] it scans up
// while d[j+1] <= d[i], where d[i] >= d[i+1] down while d[j] <= d[i+1], and
// stops with nothing where a neighbour's allele equals its own (below site N;
// at k = N the flush compares no allele). It reports a[i]'s matches with
// a[j] to k, from d[i] for j < i and from d[i+1] for j > i, zero lengths
// kept.
// The counting pass stores each (recipient a[i], site)'s count, recipient-
// major; the wrapper (ops/paint.py: collect_matches) sums them over the
// sites in place, along each recipient's row (torch's cumsum), and gives
// each recipient's first slot; the filling pass scans again and writes its reports there,
// in the C loop's order: a recipient's by site, within a site the rows
// above it and then those below, each in ascending j. So the segments are
// the host's bit for bit and in order, which K6's f64 sums need.
//
// Bound on the H100: bytes. Each pass reads a site's rows of A and D once
// (8 B a row) and its packed column; the counts are written once and read
// once (4 B a row), the segments written once (12 B each). At 5,008 x
// 16,385 sites, about 1.4 GB over both passes: 0.43 ms at 3.35 TB/s. The
// scans are short on a real panel (a match's block of rows), and a warp's
// lanes read neighbouring rows. A warp's counts scatter over recipients'
// rows, but the blocks of neighbouring sites run together, so their stores
// meet in L2; in that layout the sums over the sites are a scan along rows,
// which torch makes 8 times faster than one down the columns (on an H100
// 80GB HBM3 at 700 W: 0.77 ms against 6.40 at 5,008 x 16,385).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int GRID_Y = 65535;  // sites beyond it are looped over

// Position i's report at a site: the rows [lo, i) above it, matched from
// di = d[i], and (i, hi) below it, from di1 = d[i+1]; extent() returns false
// where an allele stopped a scan. d is the site's divergence row, read with
// its sentinels k + 1 at 0 and m.
struct Extent {
  int lo, hi;
  int di, di1;
};

__device__ __forceinline__ int div_at(const int* d, int j, int m, int sentinel) {
  return (j == 0 || j == m) ? sentinel : __ldg(d + j);
}

__device__ __forceinline__ unsigned bit_at(const unsigned* y, int j) {
  return (__ldg(y + (j >> 5)) >> (j & 31)) & 1u;
}

__device__ __forceinline__ bool extent(const int* d, const unsigned* y, int m, int k, int i,
                                       Extent& x) {
  const int s = k + 1;
  x.di = div_at(d, i, m, s);
  x.di1 = div_at(d, i + 1, m, s);
  x.lo = i;
  x.hi = i + 1;
  const unsigned yi = y ? bit_at(y, i) : 0u;
  if (x.di <= x.di1) {  // scan up
    int j = i - 1;
    while (div_at(d, j + 1, m, s) <= x.di) {
      if (y && bit_at(y, j) == yi) return false;
      --j;
    }
    x.lo = j + 1;
  }
  if (x.di >= x.di1) {  // scan down
    int j = i + 1;
    while (div_at(d, j, m, s) <= x.di1) {
      if (y && bit_at(y, j) == yi) return false;
      ++j;
    }
    x.hi = j;
  }
  return true;
}

// FILL false: counts[a[i]][r] = the reports of (site k0 + r, position i).
// FILL true: counts holds their sums over the sites up to r for each
// recipient, base each recipient's first slot; the reports are written.
template <bool FILL>
__global__ void __launch_bounds__(THREADS)
    max_within_kernel(const int* __restrict__ A, const int* __restrict__ D,
                      const unsigned* __restrict__ ycols, int rw, int m, int nk, int k0, int N,
                      int* __restrict__ counts, const long long* __restrict__ base,
                      int* __restrict__ sj, int* __restrict__ ss, int* __restrict__ se) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= m) return;
  for (int r = blockIdx.y; r < nk; r += gridDim.y) {
    const int k = k0 + r;
    const int* a = A + (size_t)r * m;
    const int* d = D + (size_t)r * m;
    const unsigned* y = k < N ? ycols + (size_t)r * rw : nullptr;
    Extent x;
    const bool any = extent(d, y, m, k, i, x);
    const int c = any ? (x.hi - x.lo - 1) : 0;
    const int rec = __ldg(a + i);
    int* at = counts + (size_t)rec * nk + r;
    if (!FILL) {
      *at = c;
      continue;
    }
    if (!c) continue;
    long long o = base[rec] + *at - c;
    for (int j = x.lo; j < i; ++j, ++o) {
      sj[o] = __ldg(a + j);
      ss[o] = x.di;
      se[o] = k;
    }
    for (int j = i + 1; j < x.hi; ++j, ++o) {
      sj[o] = __ldg(a + j);
      ss[o] = x.di1;
      se[o] = k;
    }
  }
}

}  // namespace

extern "C" {

// Sites k0 .. k0 + nk - 1 of a panel of m haplotypes and N sites (k0 + nk
// <= N + 1; site N is the flush): A, D (nk rows of m int32) the prefix and
// divergence arrays before each site (D without the sentinels: its column 0
// is not read), ycols the packed sorted columns of the sites below N (rw
// words a site, K1's layout), counts (m rows of nk int32). With base null,
// the counting pass: counts[a][r] = the reports of recipient a at site k0 + r.
// Else the filling pass: counts holds the inclusive sums of those over r for
// each recipient, base (m,) int64 each recipient's first slot in sj, ss, se.
int k9_max_within(int device, const int* A, const int* D, const int* ycols, int rw, int m,
                  int nk, int k0, int N, int* counts, const long long* base, int* sj, int* ss,
                  int* se, void* stream) {
  if (m < 2 || nk < 0 || k0 < 0 || k0 + nk > N + 1 || N >= INT_MAX - 1 ||
      (long long)rw * 32 < m || (base && !(sj && ss && se)))
    return (int)cudaErrorInvalidValue;
  if (nk == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + THREADS - 1) / THREADS, nk < GRID_Y ? nk : GRID_Y);
  const unsigned* y = reinterpret_cast<const unsigned*>(ycols);
  const cudaStream_t st = (cudaStream_t)stream;
  if (base)
    max_within_kernel<true><<<grid, THREADS, 0, st>>>(A, D, y, rw, m, nk, k0, N, counts, base,
                                                      sj, ss, se);
  else
    max_within_kernel<false><<<grid, THREADS, 0, st>>>(A, D, y, rw, m, nk, k0, N, counts,
                                                       nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

}  // extern "C"
