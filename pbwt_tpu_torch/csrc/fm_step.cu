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
// with u[pos] the zeros of colw before pos and c its zeros. A call is two
// launches on the caller's stream: k7_prefix, one block, sums the column in
// chunks of 32 words (1,024 positions), a warp a chunk, and writes the chunks'
// exclusive scan to pref (Mp/1,024 + 1 ints, 256 B at 65,536 rows) and the
// zero count; then k7_step, a thread a haplotype, reads its rank as the
// chunk's prefix plus the popcounts of at most 32 words of colw, moves it,
// and (fused) ORs the next site's bit in at pos' into the next, zeroed,
// contribution row (atomicOr: the ranks' bits are disjoint, and so are a
// rank's own). So the column is summed once a site, not once a block.
//
// The sharded build runs 32 sites of these (and their all-reduces) as one
// captured CUDA graph (parallel/sharding.py:SiteGroups), so a call carries no
// host work past the launch itself: no attribute is set or read here.
//
// Bound on the H100: neither bytes nor operations. A site moves about 12 B a
// haplotype (pos read and written, the group word read), colw once and the
// contribution row once, about 1 MB at B = Mp = 65,536, some 0.3 us at
// 3.35 TB/s; the two launches' latency (some microseconds) sets its time.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;            // k7_step
constexpr int PREFIX_THREADS = 1024;    // k7_prefix: one block
constexpr int CHUNK = 32;               // words of colw a chunk of the prefix

__global__ void __launch_bounds__(PREFIX_THREADS)
    k7_prefix(const unsigned* __restrict__ colw, int mp, int* __restrict__ pref,
              int* __restrict__ count) {
  __shared__ int sums[PREFIX_THREADS];
  __shared__ int warp_tot[PREFIX_THREADS / 32];
  const int nw = mp >> 5;
  const int nchunks = (nw + CHUNK - 1) / CHUNK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int carry = 0;
  for (int base = 0; base < nchunks; base += PREFIX_THREADS) {
    const int here = min(nchunks - base, PREFIX_THREADS);
    for (int j = warp; j < PREFIX_THREADS; j += PREFIX_THREADS / 32) {
      int v = 0;
      if (j < here) {
        const int i = (base + j) * CHUNK + lane;
        v = i < nw ? __popc(__ldg(colw + i)) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      }
      if (lane == 0) sums[j] = v;
    }
    __syncthreads();
    int v = sums[threadIdx.x];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    if (warp == 0) {
      int t = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, t, o);
        if (lane >= o) t += u;
      }
      warp_tot[lane] = t;
    }
    __syncthreads();
    if (threadIdx.x < here)
      pref[base + threadIdx.x + 1] = carry + v + (warp ? warp_tot[warp - 1] : 0);
    carry += warp_tot[PREFIX_THREADS / 32 - 1];
    __syncthreads();  // sums and warp_tot are written again by the next pass
  }
  if (threadIdx.x == 0) {
    pref[0] = 0;
    if (count != nullptr) *count = mp - carry;
  }
}

__global__ void __launch_bounds__(THREADS)
    k7_step(const int* pos, int* pos_out, const int* __restrict__ w, int s,
            const int* __restrict__ wn, int sn, int b, const unsigned* __restrict__ colw, int mp,
            const int* __restrict__ pref, unsigned* __restrict__ next) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= b) return;
  const int p = pos[i];  // pos_out may be pos: read before the write
  int pn = p;
  if (colw != nullptr) {
    const int c = mp - __ldg(pref + ((mp >> 5) + CHUNK - 1) / CHUNK);
    const int wi = p >> 5;
    int ones = __ldg(pref + wi / CHUNK);
    for (int j = wi - wi % CHUNK; j < wi; ++j) ones += __popc(__ldg(colw + j));
    ones += __popc(__ldg(colw + wi) & ((1u << (p & 31)) - 1u));
    // u = p - ones zeros before p; a one goes to c + p - u = c + ones
    pn = ((__ldg(w + i) >> s) & 1) ? c + ones : p - ones;
    pos_out[i] = pn;
  }
  if (next != nullptr && ((__ldg(wn + i) >> sn) & 1)) atomicOr(next + (pn >> 5), 1u << (pn & 31));
}

}  // namespace

extern "C" {

// K7. pos (b,) int32: this rank's haplotypes' positions before the site;
// w (b,) their group words, the site at bit s; colw (mp / 32,) the
// all-reduced packed column, or null: then no FM step is taken (pos' = pos)
// and only the scatter runs (the first site's contribution). pos_out (b,)
// receives pos' (it may be pos itself). pref (ceil(mp / 1024) + 1,), needed
// with colw, receives the column's chunk prefix: pref[j] the ones in words
// [0, 32j); count, if not null, the zero count. next (mp / 32,), if not null,
// holds zeros or other ranks' bits: bit s_next of wn (b,) is ORed in at pos'.
// mp must be a multiple of 32. With b = 0 only the prefix runs.
int k7_fm_step(int device, const int* pos, int* pos_out, const int* w, int s, const int* wn,
               int s_next, int b, const int* colw, int mp, int* count, int* next, int* pref,
               void* stream) {
  if (b < 0 || mp < 0 || mp % 32 || s < 0 || s > 31 || s_next < 0 || s_next > 31 ||
      (colw != nullptr && pref == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (colw != nullptr)
    k7_prefix<<<1, PREFIX_THREADS, 0, st>>>(reinterpret_cast<const unsigned*>(colw), mp, pref,
                                            count);
  if (b > 0 && (colw != nullptr || next != nullptr))
    k7_step<<<(b + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        pos, pos_out, w, s, wn, s_next, b, reinterpret_cast<const unsigned*>(colw), mp, pref,
        reinterpret_cast<unsigned*>(next));
  return (int)cudaGetLastError();
}

}  // extern "C"
