// Query scan against a stored panel trajectory: kernel K3 of pbwt_tpu_torch.
//
// Replaces the XLA query machinery of pbwt_tpu/ops/match_jax.py:
// match_scan_indexed (:751-827) with _site_reset (:464-531) and
// _reset_windowed (:337-461). Those restructure the reference's per-query
// loop for the TPU (one-hot MXU gathers over uint8 digit planes, 128-lane
// compaction of collapsed queries, windowed widening with a cond-gated
// fallback); none of that is carried over. Here one thread per query walks
// every site exactly as matchSequencesIndexed does (pbwtMatch.c:255-340,
// pbwt_tpu/algos/match.py:426-462):
//   * FM step of the interval [f, g) from the rank table U and count C;
//   * on a collapse (g' <= f') append the record (k, q, e, f, g) of the old
//     interval through an atomic counter, then the scalar reset
//     (pbwtMatch.c:309-320): e' from D[k] (the post-site divergence array),
//     the backward extension against haplotype A[k+1][f'] on packed words,
//     32 sites per step with __clz, and the widening walk over D[k].
//     f' == Mp reads C[k], and d at Mp reads the k+2 sentinel.
// Records land in atomic order; the caller sorts them by (k, q).
//
// Bound on the H100: latency. Each site costs each query two dependent
// 4-byte loads from a U row (the trajectory is 12 B per hap-site, 2.5 GB at
// 100k x 2048, far beyond L2), so a query's walk is a chain of ~N cache-miss
// round trips; bandwidth is idle. The design keeps every query's state in
// registers and needs no synchronisation at all, so the only cost is that
// chain; resets are rare (one per ~200 sites on mosaic queries) and short.
// Interleaving several queries per thread to hide the latency is later work.

#include <cuda_runtime.h>

namespace {

constexpr int K3_THREADS = 128;

// Row-packed words hold site j at bit 8*((j>>3)&3) + 7-(j&7) of word j>>5
// (numpy packbits bytes read as little-endian int32); this puts site j of the
// word at bit j.
__device__ __forceinline__ unsigned site_order(unsigned v) {
  return __byte_perm(__brev(v), 0, 0x0123);
}

__device__ __forceinline__ int query_bit(const int* __restrict__ xq, int j) {
  unsigned v = (unsigned)xq[j >> 5];
  return (v >> (8 * ((j >> 3) & 3) + 7 - (j & 7))) & 1;
}

__global__ void k3_scan(const int* __restrict__ U, const int* __restrict__ D,
                        const int* __restrict__ A, const int* __restrict__ C,
                        const int* __restrict__ xq_words, const int* __restrict__ xp_words,
                        int ns, int mp, int nq, int nw, int* __restrict__ e_io,
                        int* __restrict__ f_io, int* __restrict__ g_io, int* __restrict__ rec,
                        int cap, int* __restrict__ nrec) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const int* xq = xq_words + (long long)q * nw;
  int e = e_io[q], f = f_io[q], g = g_io[q];
  for (int k = 0; k < ns; ++k) {
    long long row = (long long)k * mp;
    int c = C[k];
    int x = query_bit(xq, k);
    int uf = f == mp ? c : U[row + f];
    int ug = g == mp ? c : U[row + g];
    int f1 = x ? c + f - uf : uf;
    int g1 = x ? c + g - ug : ug;
    if (g1 > f1) {
      f = f1;
      g = g1;
      continue;
    }
    int r = atomicAdd(nrec, 1);
    if (r < cap) {
      int* o = rec + 5LL * r;
      o[0] = k;
      o[1] = q;
      o[2] = e;
      o[3] = f;
      o[4] = g;
    }
    const int* dk = D + row;
    const int* ak = A + row + mp;  // prefix array after site k
    int sentinel = k + 2;
    int e1 = (f1 >= mp ? sentinel : dk[f1]) - 1;
    bool branch_a = f1 == mp || (f1 > 0 && query_bit(xq, min(max(e1, 0), nw * 32 - 1)) == 0);
    int fsel = branch_a ? g1 - 1 : f1;
    if (e1 > 0) {
      int hap = ak[min(max(fsel, 0), mp - 1)];
      const int* xp = xp_words + (long long)hap * nw;
      int j = e1 - 1;
      int rb = (j & 31) + 1;
      unsigned mask = rb == 32 ? 0xffffffffu : (1u << rb) - 1u;
      int last = -1;  // last site below e1 where query and haplotype differ
      for (int wi = j >> 5; wi >= 0; --wi, mask = 0xffffffffu) {
        unsigned v = site_order((unsigned)(xq[wi] ^ xp[wi])) & mask;
        if (v) {
          last = 32 * wi + 31 - __clz(v);
          break;
        }
      }
      e1 = last + 1;
    }
    if (branch_a) {
      int fn = fsel;
      while (fn >= 0 && dk[fn] <= e1) --fn;
      f = fn;
      g = g1;
    } else {
      int gn = f1 + 1;
      while (gn < mp && dk[gn] <= e1) ++gn;
      f = f1;
      g = gn;
    }
    e = e1;
  }
  e_io[q] = e;
  f_io[q] = f;
  g_io[q] = g;
}

}  // namespace

extern "C" {

// K3. U, D: (ns, mp) int32; A: (ns + 1, mp) int32; C: (ns,); xq_words (nq, nw)
// and xp_words (mp, nw) row-packed haplotypes with nw * 32 >= ns. e/f/g hold
// the starting intervals and receive the k = ns flush carry. rec receives up
// to cap records of five ints; nrec (zeroed by the caller) counts them all, so
// nrec > cap means the buffer overflowed.
int k3_match_scan(int device, const int* U, const int* D, const int* A, const int* C,
                  const int* xq_words, const int* xp_words, int ns, int mp, int nq, int nw,
                  int* e, int* f, int* g, int* rec, int cap, int* nrec, void* stream) {
  if (nq <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int nb = (nq + K3_THREADS - 1) / K3_THREADS;
  k3_scan<<<nb, K3_THREADS, 0, (cudaStream_t)stream>>>(U, D, A, C, xq_words, xp_words, ns, mp,
                                                       nq, nw, e, f, g, rec, cap, nrec);
  return (int)cudaGetLastError();
}

}  // extern "C"
