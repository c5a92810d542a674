// Stable PBWT column partitions on Hopper: kernels K1 and K2 of pbwt_tpu_torch.
//
// K1 k1_group_partition replaces the TPU group kernels of
// pbwt_tpu/ops/partition_pallas.py (group_partition_noa, group_partition_noa2,
// group_partition) together with the XLA two-sort gather and the stable u32
// sort around them (ops/build.py:_sort_gather, build_scan_pallas_noa*). For one
// 32-site group it gathers the natural-order words into the current sort order
// (w = w_nat[a]) and runs 32 stable two-way partitions of (a, w) by bit s of w,
// emitting each site's sorted column packed 32 rows per word (a warp ballot:
// bit i%32 of word i/32) and the site's zero count.
//
// K2 k2_partition_ad_step replaces partition_ad_step and
// partition_ad_step_blocked: one site's stable partition of (a, d, w) by bit s,
// the divergence update of pbwtCursorForwardsAD (pbwtCore.c:485-508) as two
// segmented running maxima seeded with k+1 followed by d[0] = k+2, the exclusive
// zero-rank table u and the zero count, over any row count.
//
// Bound on the H100: both are memory-bound integer passes. Per site K1 reads the
// word plane twice and moves (a, w) once, about 16 B per row; K2 reads (d, w)
// twice and moves (a, d, w, u), about 28 B per row. There is no arithmetic to
// speak of, and at the slice's widths (65k-100k rows, 0.3-3 MB a plane) every
// plane lives in the 50 MB L2, so a site costs a few microseconds of launch and
// synchronisation before it costs bandwidth.
//
// Design: where the TPU kernels build ranks with log-shift rolls and matmuls
// inside one core's VMEM, here blocks run in parallel with nothing carried
// between them, so every site is three launches: a per-block summary, a
// one-block exclusive scan of the block summaries, and a scatter that rebuilds
// each block's ranks from its carry-in. Ranks within a warp come from
// __ballot_sync and __popc (K1); K2 gives each thread eight contiguous rows and
// scans the (zeros, p reset seen, p max since reset, q reset seen, q max since
// reset) summary across threads and blocks, so the segmented maxima cross block
// boundaries exactly. Offsets are int; the callers bound the row count below
// 2^31. The first version is simple and right; fusing the 32 sites of a group
// into fewer launches is later work.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int K1_THREADS = 1024;  // one row per thread
constexpr int K2_THREADS = 256;
constexpr int K2_ITEMS = 8;       // contiguous rows per thread
constexpr int K2_TILE = K2_THREADS * K2_ITEMS;
constexpr int SCAN_THREADS = 1024;

// Summary of a run of rows in sort order: its zero count and, for each of the
// divergence scans, whether the run holds a reset and the running maximum of
// the seed since the last one. The p scan restarts after a zero, the q scan
// after a one (pbwtCore.c:489-503).
struct Sum {
  int z;
  int ph, pt;
  int qh, qt;
};

__device__ __forceinline__ Sum sum_identity() { return Sum{0, 0, INT_MIN, 0, INT_MIN}; }

// a precedes b
__device__ __forceinline__ Sum combine(const Sum& a, const Sum& b) {
  Sum r;
  r.z = a.z + b.z;
  r.ph = a.ph | b.ph;
  r.pt = b.ph ? b.pt : max(a.pt, b.pt);
  r.qh = a.qh | b.qh;
  r.qt = b.qh ? b.qt : max(a.qt, b.qt);
  return r;
}

// Exclusive scan of per-block summaries in one block; writes the zero total.
__global__ void scan_blocks(const Sum* __restrict__ in, Sum* __restrict__ excl, int nb,
                            int* __restrict__ total_z) {
  __shared__ Sum tile[SCAN_THREADS];
  __shared__ Sum carry;
  if (threadIdx.x == 0) carry = sum_identity();
  __syncthreads();
  for (int base = 0; base < nb; base += SCAN_THREADS) {
    int i = base + threadIdx.x;
    if (i < nb) tile[threadIdx.x] = in[i];
    __syncthreads();
    if (threadIdx.x == 0) {
      Sum c = carry;
      int m = min(SCAN_THREADS, nb - base);
      for (int j = 0; j < m; ++j) {
        Sum v = tile[j];
        tile[j] = c;
        c = combine(c, v);
      }
      carry = c;
    }
    __syncthreads();
    if (i < nb) excl[i] = tile[threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x == 0) *total_z = carry.z;
}

// ---------------------------------------------------------------- K1 ----

__global__ void k1_gather(const int* __restrict__ w_nat, const int* __restrict__ a_in, int n,
                          int* __restrict__ a_out, int* __restrict__ w_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    int ai = a_in[i];
    a_out[i] = ai;
    w_out[i] = w_nat[ai];
  }
}

// Site s: emit the packed sorted column and the block's zero count.
__global__ void k1_count(const int* __restrict__ w, int n, int s, unsigned* __restrict__ ycol,
                         int rw, Sum* __restrict__ sums) {
  __shared__ int warp_z[K1_THREADS / 32];
  int i = blockIdx.x * K1_THREADS + threadIdx.x;
  bool valid = i < n;
  int key = valid ? (w[i] >> s) & 1 : 0;
  unsigned ones = __ballot_sync(0xffffffffu, valid && key);
  unsigned zeros = __ballot_sync(0xffffffffu, valid && !key);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    if ((i >> 5) < rw) ycol[i >> 5] = ones;
    warp_z[warp] = __popc(zeros);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Sum r = sum_identity();
    for (int j = 0; j < K1_THREADS / 32; ++j) r.z += warp_z[j];
    sums[blockIdx.x] = r;
  }
}

// Site s: stable scatter of (a, w); zeros first, ones after the count.
__global__ void k1_scatter(const int* __restrict__ a, const int* __restrict__ w, int n, int s,
                           const Sum* __restrict__ block_off, const int* __restrict__ count,
                           int* __restrict__ a_out, int* __restrict__ w_out) {
  __shared__ int warp_off[K1_THREADS / 32];
  int i = blockIdx.x * K1_THREADS + threadIdx.x;
  bool valid = i < n;
  int wi = valid ? w[i] : 0;
  int key = (wi >> s) & 1;
  unsigned zeros = __ballot_sync(0xffffffffu, valid && !key);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_off[warp] = __popc(zeros);
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int j = 0; j < K1_THREADS / 32; ++j) {
      int v = warp_off[j];
      warp_off[j] = acc;
      acc += v;
    }
  }
  __syncthreads();
  if (!valid) return;
  int zr = block_off[blockIdx.x].z + warp_off[warp] + __popc(zeros & ((1u << lane) - 1u));
  int dst = key ? *count + (i - zr) : zr;
  a_out[dst] = a[i];
  w_out[dst] = wi;
}

// ---------------------------------------------------------------- K2 ----

__device__ __forceinline__ int seed_at(const int* __restrict__ d, int i, int kk) {
  int v = d[i];
  return i == 0 ? max(v, kk + 1) : v;
}

// One thread's summary of its K2_ITEMS rows starting at i0.
__device__ __forceinline__ Sum k2_thread_sum(const int* __restrict__ d, const int* __restrict__ w,
                                             int n, int s, int kk, int i0) {
  Sum r = sum_identity();
  for (int t = 0; t < K2_ITEMS; ++t) {
    int i = i0 + t;
    if (i >= n) break;
    int v = seed_at(d, i, kk);
    r.pt = max(r.pt, v);
    r.qt = max(r.qt, v);
    if ((w[i] >> s) & 1) {
      r.qh = 1;
      r.qt = INT_MIN;
    } else {
      r.z++;
      r.ph = 1;
      r.pt = INT_MIN;
    }
  }
  return r;
}

// Hillis-Steele scan of the block's thread summaries; returns the exclusive
// prefix of this thread and the block total.
__device__ Sum block_scan(Sum mine, Sum* sh, Sum* total) {
  int t = threadIdx.x;
  sh[t] = mine;
  __syncthreads();
  for (int off = 1; off < K2_THREADS; off <<= 1) {
    Sum v = sh[t];
    if (t >= off) v = combine(sh[t - off], v);
    __syncthreads();
    sh[t] = v;
    __syncthreads();
  }
  *total = sh[K2_THREADS - 1];
  return t ? sh[t - 1] : sum_identity();
}

__global__ void k2_summary(const int* __restrict__ d, const int* __restrict__ w, int n, int s,
                           int kk, Sum* __restrict__ sums) {
  __shared__ Sum sh[K2_THREADS];
  int i0 = blockIdx.x * K2_TILE + threadIdx.x * K2_ITEMS;
  Sum total;
  block_scan(k2_thread_sum(d, w, n, s, kk, i0), sh, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void k2_scatter(const int* __restrict__ a, const int* __restrict__ d,
                           const int* __restrict__ w, int n, int s, int kk,
                           const Sum* __restrict__ carry, const int* __restrict__ count,
                           int* __restrict__ a_out, int* __restrict__ d_out,
                           int* __restrict__ w_out, int* __restrict__ u_out) {
  __shared__ Sum sh[K2_THREADS];
  int i0 = blockIdx.x * K2_TILE + threadIdx.x * K2_ITEMS;
  Sum total;
  Sum ex = block_scan(k2_thread_sum(d, w, n, s, kk, i0), sh, &total);
  Sum st = combine(carry[blockIdx.x], ex);
  int c = *count;
  int zr = st.z, rp = st.pt, rq = st.qt;
  for (int t = 0; t < K2_ITEMS; ++t) {
    int i = i0 + t;
    if (i >= n) break;
    int v = seed_at(d, i, kk);
    int wi = w[i];
    rp = max(rp, v);
    rq = max(rq, v);
    u_out[i] = zr;
    int dst, dv;
    if ((wi >> s) & 1) {
      dst = c + (i - zr);
      dv = rq;
      rq = INT_MIN;
    } else {
      dst = zr;
      dv = rp;
      rp = INT_MIN;
      zr++;
    }
    a_out[dst] = a[i];
    w_out[dst] = wi;
    d_out[dst] = dst == 0 ? kk + 2 : dv;
  }
}

}  // namespace

#define LAUNCH_CHECK()                           \
  do {                                           \
    cudaError_t err_ = cudaGetLastError();       \
    if (err_ != cudaSuccess) return (int)err_;   \
  } while (0)

extern "C" {

// Rows per block of K1 (which = 1) and K2 (which = 2), and the size in ints of
// one block summary; the Python wrappers size their scratch with these.
int pbwt_tile(int which) {
  switch (which) {
    case 1: return K1_THREADS;
    case 2: return K2_TILE;
    case 3: return (int)(sizeof(Sum) / sizeof(int));
    default: return -1;
  }
}

// K1. w_nat: natural-order words; a_in: the prefix array entering the group.
// Writes a_out/w_out (after 32 sites), ycols (32 x rw packed sorted columns),
// counts (32 zero counts). a_tmp/w_tmp and the two summary arrays (one Sum per
// block) are scratch.
int k1_group_partition(int device, const int* w_nat, const int* a_in, int n, int* a_out,
                       int* w_out, int* a_tmp, int* w_tmp, int* ycols, int rw, int* counts,
                       void* sums, void* offs, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  int nb = (n + K1_THREADS - 1) / K1_THREADS;
  k1_gather<<<nb, K1_THREADS, 0, st>>>(w_nat, a_in, n, a_out, w_out);
  LAUNCH_CHECK();
  int *ac = a_out, *wc = w_out, *an = a_tmp, *wn = w_tmp;
  for (int s = 0; s < 32; ++s) {
    k1_count<<<nb, K1_THREADS, 0, st>>>(wc, n, s, (unsigned*)(ycols + (size_t)s * rw), rw,
                                        (Sum*)sums);
    LAUNCH_CHECK();
    scan_blocks<<<1, SCAN_THREADS, 0, st>>>((const Sum*)sums, (Sum*)offs, nb, counts + s);
    LAUNCH_CHECK();
    k1_scatter<<<nb, K1_THREADS, 0, st>>>(ac, wc, n, s, (const Sum*)offs, counts + s, an, wn);
    LAUNCH_CHECK();
    int* t = ac; ac = an; an = t;
    t = wc; wc = wn; wn = t;
  }
  return 0;  // 32 swaps: the result is back in a_out/w_out
}

// K2. One site: bit s of w, global site index kk. d is the divergence array
// entering the site (no d[M] sentinel); count receives the zero count.
int k2_partition_ad_step(int device, const int* a, const int* d, const int* w, int n, int s,
                         int kk, int* a_out, int* d_out, int* w_out, int* u_out, int* count,
                         void* sums, void* carry, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  int nb = (n + K2_TILE - 1) / K2_TILE;
  k2_summary<<<nb, K2_THREADS, 0, st>>>(d, w, n, s, kk, (Sum*)sums);
  LAUNCH_CHECK();
  scan_blocks<<<1, SCAN_THREADS, 0, st>>>((const Sum*)sums, (Sum*)carry, nb, count);
  LAUNCH_CHECK();
  k2_scatter<<<nb, K2_THREADS, 0, st>>>(a, d, w, n, s, kk, (const Sum*)carry, count, a_out, d_out,
                                        w_out, u_out);
  LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
