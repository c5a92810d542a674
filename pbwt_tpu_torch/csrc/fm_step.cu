// One site of the sharded construction's FM position chase: kernel K7 of
// pbwt_tpu_torch.
//
// Replaces the XLA body of pbwt_tpu/parallel/sharding.py:_fm_group_step
// (:56-92; not Pallas). A rank owns B haplotypes in natural order and keeps
// each one's position in the global sort order. Per site, every rank ORs its
// haplotypes' bits into a zeroed packed column at their positions, one
// all-reduce (SUM over disjoint bits, so an OR) makes the whole packed sorted
// column colw (Mp/32 words, position i at bit i % 32 of word i / 32)
// everywhere, and each position moves by the FM map
//
//     pos' = u[pos]            if y == 0
//     pos' = c + pos - u[pos]  if y == 1
//
// with u[pos] the zeros of colw before pos and c its zeros. One launch does a
// site: the ranks from colw, pos', the zero count, and (fused) the scatter of
// the next site's bits at pos' into the next, zeroed, contribution row, so a
// site is one launch and one collective. Optionally it also unpacks colw into
// one int32 a position (bit 0), the key of the replicated divergence step
// (kernel K2's single-site entry, ops/partition.py:partition_ad_step).
//
// Each block stages colw in shared memory where it fits (Mp up to 786,432),
// sums it in chunks of 32 words (1,024 positions) with a warp a chunk, scans
// the chunk sums with one warp, and then a thread a haplotype (grid-stride)
// reads its rank as the chunk's prefix plus the popcounts of at most 32
// words. The next site's bits go in with atomicOr: the ranks' bits are
// disjoint, and so are a rank's own.
//
// Bound on the H100: neither bytes nor operations. A site moves about 12 B a
// haplotype (pos read and written, the group word read), colw once and the
// contribution row once, about 1 MB at B = Mp = 65,536, some 0.3 us at
// 3.35 TB/s; launch latency (some microseconds) sets its time, and every block
// re-reading colw from L2 (8 KB there) is the design's redundant work.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 32;                  // words of colw a chunk of the scan
constexpr int STAGE_BYTES = 96 * 1024;     // colw staged in shared memory up to this
constexpr int SMEM_MAX = 227 * 1024;       // dynamic shared memory a block can have

__global__ void __launch_bounds__(THREADS)
    k7_kernel(const int* pos, int* pos_out, const int* __restrict__ w, int s,
              const int* __restrict__ wn, int sn, int B, const unsigned* __restrict__ colw,
              int Mp, int staged, int* __restrict__ count, unsigned* __restrict__ next,
              int* __restrict__ col) {
  extern __shared__ unsigned smem[];
  const int nw = Mp >> 5;
  const int nchunks = (nw + CHUNK - 1) / CHUNK;
  int* pref = reinterpret_cast<int*>(smem);  // nchunks + 1: exclusive prefix
  const unsigned* cw = colw;
  int c = 0;
  if (colw != nullptr) {
    if (staged) {
      unsigned* st = smem + nchunks + 1;
      for (int i = threadIdx.x; i < nw; i += THREADS) st[i] = __ldg(colw + i);
      cw = st;
      __syncthreads();
    }
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int j = warp; j < nchunks; j += THREADS / 32) {
      const int i = j * CHUNK + lane;
      int v = i < nw ? __popc(cw[i]) : 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) pref[j + 1] = v;
    }
    __syncthreads();
    if (warp == 0) {
      int carry = 0;
      for (int j0 = 0; j0 < nchunks; j0 += 32) {
        const int j = j0 + lane;
        int v = j < nchunks ? pref[j + 1] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += t;
        }
        if (j < nchunks) pref[j + 1] = carry + v;
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
      if (lane == 0) pref[0] = 0;
    }
    __syncthreads();
    c = Mp - pref[nchunks];
    if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *count = c;
  }
  const int stride = gridDim.x * THREADS;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < B; i += stride) {
    const int p = pos[i];
    int pn = p;
    if (colw != nullptr) {
      const int wi = p >> 5;
      int ones = pref[wi / CHUNK];
      for (int j = wi - wi % CHUNK; j < wi; ++j) ones += __popc(cw[j]);
      ones += __popc(cw[wi] & ((1u << (p & 31)) - 1u));
      // u = p - ones zeros before p; a one goes to c + p - u = c + ones
      pn = ((__ldg(w + i) >> s) & 1) ? c + ones : p - ones;
      pos_out[i] = pn;
    }
    if (next != nullptr && ((__ldg(wn + i) >> sn) & 1))
      atomicOr(next + (pn >> 5), 1u << (pn & 31));
  }
  if (col != nullptr && colw != nullptr)
    for (int i = blockIdx.x * THREADS + threadIdx.x; i < Mp; i += stride)
      col[i] = (cw[i >> 5] >> (i & 31)) & 1;
}

}  // namespace

extern "C" {

// K7. pos (B,) int32: this rank's haplotypes' positions before the site;
// w (B,) their group words, the site at bit s; colw (mp / 32,) the
// all-reduced packed column, or null: then no FM step is taken (pos' = pos)
// and only the scatter runs (the first site's contribution). pos_out (B,)
// receives pos' (it may be pos itself); count, if not null, the zero count.
// next (mp / 32,), if not null, holds zeros or other ranks' bits: bit s_next
// of wn (B,) is ORed in at pos'. col (mp,), if not null, receives colw one
// position an int32. mp must be a multiple of 32.
int k7_fm_step(int device, const int* pos, int* pos_out, const int* w, int s, const int* wn,
               int s_next, int b, const int* colw, int mp, int* count, int* next, int* col,
               void* stream) {
  if (b < 0 || mp < 0 || mp % 32 || s < 0 || s > 31 || s_next < 0 || s_next > 31)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nw = mp >> 5;
  const int nchunks = (nw + CHUNK - 1) / CHUNK;
  long long smem = 4LL * (nchunks + 1);
  const int staged = colw != nullptr && 4LL * nw <= STAGE_BYTES;
  if (staged) smem += 4LL * nw;
  if (colw == nullptr) smem = 0;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(k7_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long work = (col != nullptr && colw != nullptr && mp > b) ? mp : b;
  if (work == 0) return (int)cudaSuccess;
  long long blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 4LL * sms) blocks = 4LL * sms;
  k7_kernel<<<(unsigned)blocks, THREADS, (size_t)smem, (cudaStream_t)stream>>>(
      pos, pos_out, w, s, wn, s_next, b, reinterpret_cast<const unsigned*>(colw), mp, staged,
      count, reinterpret_cast<unsigned*>(next), col);
  return (int)cudaGetLastError();
}

}  // extern "C"
