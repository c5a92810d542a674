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
// segment order, in f64: the weights are integers, so the sums are exact below
// 2^53 and the quotient is the host's to the bit. A block takes one target and
// CHUNK consecutive reference sites, a thread a site, so that a donor's alleles
// Xref[jref][k] are read along the row by neighbouring threads. A target's
// segments are sorted by start and few of them reach any one chunk: the block
// reads them 256 at a time, keeps those that can cover the chunk's range of
// frame coordinates (s < the largest, e > the smallest; the others weigh
// nothing there), packs them in order into shared memory, and every thread
// walks the packed list.
//
// Bound on the H100: bytes. The function must read one allele byte a covering
// (segment, site) pair and write 10 bytes a (target, site): 8 of dosage, the
// allele and the voted flag; the four f64 operations a pair are far below the
// card's f64 rate. Blocks of one chunk run side by side (the target is the
// grid's fast axis), so the chunk's slab of Xref, Mref x 256 bytes, is read
// from L2.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int CHUNK = 256;  // reference sites, and threads, a block
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

  // the chunk's range of frame coordinates
  int lo = live ? ko : INT_MAX, hi = live ? ko : INT_MIN;
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    sh_lo[warp] = lo;
    sh_hi[warp] = hi;
  }
  __syncthreads();
  lo = sh_lo[0];
  hi = sh_hi[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    lo = min(lo, sh_lo[w]);
    hi = max(hi, sh_hi[w]);
  }

  double ssum = 0.0, score = 0.0;
  const unsigned char* xk = Xref + k;
  const long long end = seg_off[t + 1];
  for (long long base = seg_off[t]; base < end; base += CHUNK) {
    // this thread's segment of the tile; kept if it can cover a site here
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
    __syncthreads();  // the last tile's list has been walked
    if (lane == 0) sh_n[warp] = __popc(kept);
    __syncthreads();
    int at = __popc(kept & ((1u << lane) - 1u)), n = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) at += sh_n[w];
      n += sh_n[w];
    }
    if (keep) {
      sh_j[at] = j;
      sh_s[at] = s;
      sh_e[at] = e;
    }
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

extern "C" {

// K5. seg_off (nt + 1,) int64 offsets of each target's segments; seg_jref,
// seg_s, seg_e int32 donor, start and end (frame coordinates) of each segment,
// sorted by (target, start); Xref (mref, nref) uint8 donor alleles in natural
// order; kold (nref,) int32 the frame coordinate of each reference site;
// ref_freq (nref,) f64. Writes dosage (nt, nref) f64 = score / sum of the
// weights (kold - s)(e - kold) > 0 over the target's segments with s < kold,
// or ref_freq where none weighs; x = dosage > 0.5; voted = some segment weighs.
int k5_impute_vote(int device, const long long* seg_off, const int* seg_jref, const int* seg_s,
                   const int* seg_e, int nt, const unsigned char* Xref, int nref, const int* kold,
                   const double* ref_freq, double* dosage, unsigned char* x,
                   unsigned char* voted, void* stream) {
  if (nt <= 0 || nref <= 0) return 0;
  int chunks = (nref + CHUNK - 1) / CHUNK;
  if (chunks > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  k5_vote<<<dim3(nt, chunks), CHUNK, 0, (cudaStream_t)stream>>>(
      seg_off, seg_jref, seg_s, seg_e, Xref, nref, kold, ref_freq, dosage, x, voted);
  return (int)cudaGetLastError();
}

}  // extern "C"
