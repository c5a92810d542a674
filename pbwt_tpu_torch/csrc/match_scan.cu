// Query scan against a stored panel trajectory: kernel K3 of pbwt_tpu_torch,
// and k3_rank_plane, which packs the FM rank table for it.
//
// Replaces the XLA query machinery of pbwt_tpu/ops/match_jax.py:
// match_scan_indexed (:751-827) with _site_reset (:464-531) and
// _reset_windowed (:337-461). Those restructure the reference's per-query
// loop for the TPU (one-hot MXU gathers over uint8 digit planes, 128-lane
// compaction of collapsed queries, windowed widening with a cond-gated
// fallback); none of that is carried over. Every query walks every site as
// matchSequencesIndexed does (pbwtMatch.c:255-340,
// pbwt_tpu/algos/match.py:426-462): the FM step of its interval [f, g), and
// on a collapse (g' <= f') a record (k, q, e, f, g) of the old interval
// through an atomic counter, then the reset (pbwtMatch.c:309-320): e' from
// D[k], the backward extension against haplotype A[k+1][f'] on packed words,
// and the widening walk over D[k]. Records land in atomic order; the caller
// sorts them by (k, q).
//
// Bound on the H100: latency, not bytes. The sites of a query are a true
// chain (the address read at site k+1 is the answer of site k), so a scan
// cannot take less than sites x one dependent load, whatever the width of
// the batch; the card's bandwidth and its 132 SMs only decide how many
// chains run side by side. The design shortens the load and keeps every
// chain to itself:
//   * Ranks come from a bit plane, not from the int32 table U. U[k][i] is the
//     number of zeros of site k before position i: a rank over a bit vector.
//     k3_rank_plane stores it as blocks of 96 rows, each one aligned int4
//     {rank at the block's start, the block's zero bits}, with one block more
//     so that position Mp reads the site's count. A rank is one aligned load
//     and three __popc. The plane is Mp x Ns / 6 bytes, 1/24 of U: 34 MB at
//     100,352 x 2,048 where U is 822 MB, so a site's load is an L2 hit in a
//     17 KB slice instead of a miss to device memory 400 KB on. A dependent
//     load costs the same up to 24 MB of plane, 5% more at 34 MB and a third
//     more at 48 MB (Mp x Ns = 2.9e8), where the plane begins to leave the
//     50 MB L2; blocks of 8 words (Mp x Ns / 7 bytes) and of 2 (Mp x Ns / 4)
//     were no faster.
//   * A query belongs to a whole warp and the warps are spread over every SM
//     (a block is two warps; a warp takes queries j, j + G, ...). In the FM
//     step the even lanes read the rank at f and the odd ones at g, one load
//     instruction, shared by shuffle; C[k + 1] and the query's next 32 sites
//     are fetched a step ahead, off the chain.
//   * The reset is done by the warp: its first loads (D[k][f'], both
//     candidates of A[k+1], and the first 32 entries of either walk) go out
//     together; the backward extension compares 32 words of the query and
//     the haplotype a step and finds the highest differing one by ballot;
//     the widening walk tests 32 entries of D[k] a step. A collapse holds no
//     other query; groups of 8 and 16 lanes a query were slower at every
//     batch size tried.
// What a site costs, what the card's dependent load costs and what each of
// these choices gave is measured by tools/k3_probe.py and written down in
// PERF.md: about half of a site is the load, a third the step's own
// instructions (a single chain has nothing to overlap them with), a tenth
// the resets.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int K3_LANES = 32;             // lanes a query: the warp
constexpr unsigned GROUP = 0xffffffffu;  // their mask
constexpr int K3_THREADS = 64;           // threads a block of the scan
constexpr int PLANE_WORDS = 4;  // int32 words a block of the plane: one int4
constexpr int PLANE_ROWS = 32 * (PLANE_WORDS - 1);
constexpr int PLANE_WARPS = 4;                 // warps a block of k3_plane
constexpr int PLANE_SPAN = 32 * PLANE_ROWS;    // rows a warp: a block a lane
constexpr int PLANE_LOADS = PLANE_SPAN / 128;  // 16-byte loads a lane (24)

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

__device__ __forceinline__ unsigned low_bits(int n) {  // the n lowest bits, any n
  return n >= 32 ? 0xffffffffu : n <= 0 ? 0u : (1u << n) - 1u;
}

// Zeros of a site before position i (0 <= i <= mp): one block of its slice.
__device__ __forceinline__ int plane_rank(const int* __restrict__ site, int i) {
  int b = i / PLANE_ROWS, r = i - b * PLANE_ROWS;
  int4 w = __ldg(reinterpret_cast<const int4*>(site) + b);
  return w.x + __popc((unsigned)w.y & low_bits(r)) + __popc((unsigned)w.z & low_bits(r - 32)) +
         __popc((unsigned)w.w & low_bits(r - 64));
}

// The reset of one query that collapsed at global site k by its warp (t: the
// lane); the tables' first row is site k0. Returns the new (e, f, g). Not
// inlined, and the rows of D and A are found in here: the scan's loop then
// carries nothing for it.
__device__ __noinline__ int3 group_reset(const int* __restrict__ D, const int* __restrict__ A,
                                         const int* __restrict__ xq,
                                         const int* __restrict__ xp_words, int k, int k0, int f1,
                                         int g1, int mp, int nw, int t) {
  constexpr int L = K3_LANES;
  const int* dk = D + (size_t)(k - k0) * mp;  // the order after site k: its D, the next A
  const int* ak = A + (size_t)(k - k0 + 1) * mp;
  // everything whose address is known now, in one round: the divergence at
  // f1, both candidates of the haplotype, the first step of either walk
  int ia = g1 - 1 - t, ib = f1 + 1 + t;
  int d_f1 = f1 >= mp ? k + 2 : dk[f1];
  int hap_a = ak[min(max(g1 - 1, 0), mp - 1)];
  int hap_b = ak[min(max(f1, 0), mp - 1)];
  int da = ia >= 0 ? dk[ia] : INT_MAX;
  int db = ib < mp ? dk[ib] : INT_MAX;
  int e1 = d_f1 - 1;
  bool branch_a = f1 == mp || (f1 > 0 && query_bit(xq, min(max(e1, 0), nw * 32 - 1)) == 0);
  if (e1 > 0) {
    // last site below e1 where query and haplotype differ: L words a step
    // from word (e1 - 1) >> 5 down, the highest differing word by ballot
    const int* xp = xp_words + (size_t)(branch_a ? hap_a : hap_b) * nw;
    int j = e1 - 1, last = -1;
    for (int w0 = j >> 5; w0 >= 0; w0 -= L) {
      int w = w0 - t;
      unsigned v = 0;
      if (w >= 0) {
        v = site_order((unsigned)(xq[w] ^ xp[w]));
        if (w == (j >> 5)) v &= low_bits((j & 31) + 1);
      }
      unsigned hit = __ballot_sync(GROUP, v != 0);
      if (hit) {
        last = __shfl_sync(GROUP, 32 * w + 31 - __clz(v), __ffs(hit) - 1);
        break;
      }
    }
    e1 = last + 1;
  }
  // the widening walk: the first entry of D[k] above e1, L entries a step;
  // a position outside the array counts as above (INT_MAX)
  if (branch_a) {
    int fn = g1 - 1;
    for (int dv = da;;) {
      unsigned stop = __ballot_sync(GROUP, dv > e1);
      if (stop) {
        fn -= __ffs(stop) - 1;
        break;
      }
      fn -= L;
      dv = fn - t >= 0 ? dk[fn - t] : INT_MAX;
    }
    return make_int3(e1, fn, g1);
  }
  int gn = f1 + 1;
  for (int dv = db;;) {
    unsigned stop = __ballot_sync(GROUP, dv > e1);
    if (stop) {
      gn += __ffs(stop) - 1;
      break;
    }
    gn += L;
    dv = gn + t < mp ? dk[gn + t] : INT_MAX;
  }
  return make_int3(e1, f1, gn);
}

__global__ void __launch_bounds__(K3_THREADS)
k3_scan(const int* __restrict__ plane, size_t plane_stride, const int* __restrict__ D,
        const int* __restrict__ A, const int* __restrict__ C, const int* __restrict__ xq_words,
        const int* __restrict__ xp_words, int ns, int mp, int nq, int nw, int k0,
        int* __restrict__ e_io, int* __restrict__ f_io, int* __restrict__ g_io,
        int* __restrict__ rec, int cap, int* __restrict__ nrec) {
  constexpr int L = K3_LANES;
  const int t = threadIdx.x & 31;  // lane of the query's warp
  const int groups = gridDim.x * (K3_THREADS / L);
  const int kend = k0 + ns;  // the tables' rows are the global sites k0 .. kend - 1
  for (int q = blockIdx.x * (K3_THREADS / L) + threadIdx.x / L; q < nq; q += groups) {
    const int* xq = xq_words + (size_t)q * nw;
    int e = e_io[q], f = f_io[q], g = g_io[q];
    int c_next = __ldg(C);
    unsigned xw_next = (unsigned)xq[k0 >> 5];
    const int* site = plane;
    for (int kb = k0; kb < kend; kb += 32) {
      // off the chain: the query's 32 sites of this word were asked for a
      // word ago, a site's count a site ago
      const unsigned xw = site_order(xw_next);
      if ((kb >> 5) + 1 < nw) xw_next = (unsigned)xq[(kb >> 5) + 1];
      const int send = min(32, kend - kb);
#pragma unroll 4
      for (int s = 0; s < send; ++s, site += plane_stride) {
        const int k = kb + s;
        const int c = c_next;
        if (k + 1 < kend) c_next = __ldg(C + (k + 1 - k0));
        const bool x = (xw >> s) & 1;
        // the chain: even lanes rank f, odd lanes g
        int u = plane_rank(site, (t & 1) ? g : f);
        int uf = __shfl_sync(GROUP, u, 0), ug = __shfl_sync(GROUP, u, 1);
        int f1 = x ? c + f - uf : uf;
        int g1 = x ? c + g - ug : ug;
        if (g1 > f1) {
          f = f1;
          g = g1;
          continue;
        }
        if (t == 0) {
          int r = atomicAdd(nrec, 1);
          if (r < cap) {
            int* o = rec + 5LL * r;
            o[0] = k;
            o[1] = q;
            o[2] = e;
            o[3] = f;
            o[4] = g;
          }
        }
        int3 r = group_reset(D, A, xq, xp_words, k, k0, f1, g1, mp, nw, t);
        e = r.x;
        f = r.y;
        g = r.z;
      }
    }
    if (t == 0) {
      e_io[q] = e;
      f_io[q] = f;
      g_io[q] = g;
    }
  }
}

// Rows i .. i + 3 of a site's ranks (i a multiple of 4); rows at and beyond
// mp read as c. vec: the rows are 16-byte aligned, so four are one load.
__device__ __forceinline__ int4 plane_rows(const int* __restrict__ u, int i, int mp, int c,
                                           bool vec) {
  if (vec && i < mp) return __ldg(reinterpret_cast<const int4*>(u + i));
  int4 r;
  r.x = i < mp ? __ldg(u + i) : c;
  r.y = i + 1 < mp ? __ldg(u + i + 1) : c;
  r.z = i + 2 < mp ? __ldg(u + i + 2) : c;
  r.w = i + 3 < mp ? __ldg(u + i + 3) : c;
  return r;
}

// A warp makes 32 consecutive blocks of a site's plane (3,072 rows, 12 KB of
// U): each lane issues its 24 loads of 16 bytes before any of them is used,
// so an SM has a few hundred KB in flight. Bit i of the site is
// U[k][i + 1] != U[k][i], its neighbour taken from the next lane's load (from
// the next load's first lane at lane 31, and from the row after the span at
// the span's end); rows at and beyond mp read as C[k] and give no bit, so the
// block that holds position mp ranks it C[k]. Eight lanes' nibbles make a
// word; words and each load's first rank go through shared memory so that
// lane b writes block b as one int4, and a warp's stores are whole sectors.
__global__ void __launch_bounds__(32 * PLANE_WARPS)
k3_plane(const int* __restrict__ U, const int* __restrict__ C, int mp, int nblk, bool vec,
         int* __restrict__ plane) {
  __shared__ int first[PLANE_WARPS][32 * PLANE_LOADS];  // U at the span's rows 4i
  __shared__ unsigned bits[PLANE_WARPS][PLANE_SPAN / 32];
  const unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = (blockIdx.y * PLANE_WARPS + warp) * 32;  // the warp's first block
  if (b0 >= nblk) return;
  const int k = blockIdx.x, base = b0 * PLANE_ROWS;
  const int* u = U + (size_t)k * mp;
  const int c = __ldg(C + k);
  int4 v[PLANE_LOADS];
#pragma unroll
  for (int n = 0; n < PLANE_LOADS; ++n) v[n] = plane_rows(u, base + 128 * n + 4 * lane, mp, c, vec);
  const int after = base + PLANE_SPAN < mp ? __ldg(u + base + PLANE_SPAN) : c;
#pragma unroll
  for (int n = 0; n < PLANE_LOADS; ++n) {
    const int head = __shfl_sync(FULL, n + 1 < PLANE_LOADS ? v[n + 1].x : after, 0);
    int nx = __shfl_down_sync(FULL, v[n].x, 1);
    if (lane == 31) nx = head;
    const unsigned nib = (unsigned)(v[n].y != v[n].x) | (unsigned)(v[n].z != v[n].y) << 1 |
                         (unsigned)(v[n].w != v[n].z) << 2 | (unsigned)(nx != v[n].w) << 3;
    unsigned word = nib << (4 * (lane & 7));
    word |= __shfl_xor_sync(FULL, word, 1);
    word |= __shfl_xor_sync(FULL, word, 2);
    word |= __shfl_xor_sync(FULL, word, 4);
    if ((lane & 7) == 0) bits[warp][4 * n + (lane >> 3)] = word;
    first[warp][32 * n + lane] = v[n].x;
  }
  __syncwarp();
  const int b = b0 + lane;
  if (b < nblk) {
    const int4 o = make_int4(first[warp][PLANE_ROWS / 4 * lane], (int)bits[warp][3 * lane],
                             (int)bits[warp][3 * lane + 1], (int)bits[warp][3 * lane + 2]);
    reinterpret_cast<int4*>(plane)[(size_t)k * nblk + b] = o;
  }
}

}  // namespace

extern "C" {

// What the wrappers must know of the layout: 1: int32 words a block of the
// rank plane.
int k3_plane_layout(int which) { return which == 1 ? PLANE_WORDS : 0; }

// The rank plane of a trajectory. U (ns, mp) int32 exclusive zero ranks, C
// (ns,) zero counts; plane (ns, mp / PLANE_ROWS + 1, PLANE_WORDS) int32,
// every word of it written.
int k3_rank_plane(int device, const int* U, const int* C, int ns, int mp, int* plane,
                  void* stream) {
  if (ns <= 0) return 0;
  if (mp < 0 || (reinterpret_cast<uintptr_t>(plane) & 15)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nblk = mp / PLANE_ROWS + 1;
  const bool vec = (mp & 3) == 0 && (reinterpret_cast<uintptr_t>(U) & 15) == 0;
  const dim3 grid(ns, (nblk + 32 * PLANE_WARPS - 1) / (32 * PLANE_WARPS));
  k3_plane<<<grid, 32 * PLANE_WARPS, 0, (cudaStream_t)stream>>>(U, C, mp, nblk, vec, plane);
  return (int)cudaGetLastError();
}

// K3. plane from k3_rank_plane; D (ns, mp) and A (ns + 1, mp) int32; C (ns,):
// the tables of the global sites k0 .. k0 + ns - 1, k0 a multiple of 32 (the
// scan loads a query word a block of 32 sites). xq_words (nq, nw) and
// xp_words (mp, nw) the whole row-packed haplotypes, nw * 32 >= k0 + ns.
// e/f/g hold the intervals entering site k0 and receive those after the last
// site (the flush carry). rec receives up to cap records of five ints, the
// site global; nrec (zeroed by the caller) counts them all, so nrec > cap
// means the buffer overflowed.
int k3_match_scan(int device, const int* plane, const int* D, const int* A, const int* C,
                  const int* xq_words, const int* xp_words, int ns, int mp, int nq, int nw,
                  int k0, int* e, int* f, int* g, int* rec, int cap, int* nrec,
                  void* stream) {
  if (nq <= 0 || ns <= 0) return 0;
  if (k0 < 0 || (k0 & 31) || (long long)nw * 32 < (long long)k0 + ns)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k3_scan, K3_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  // as many blocks as the card holds at once, or fewer if the queries need
  // fewer; a group of lanes takes the queries j, j + groups, ...
  const int per_block = K3_THREADS / K3_LANES;
  long long want = ((long long)nq + per_block - 1) / per_block;
  long long fit = (long long)per_sm * sms;
  int nb = (int)(want < fit ? want : fit);
  size_t plane_stride = (size_t)(mp / PLANE_ROWS + 1) * PLANE_WORDS;
  k3_scan<<<nb, K3_THREADS, 0, (cudaStream_t)stream>>>(
      plane, plane_stride, D, A, C, xq_words, xp_words, ns, mp, nq, nw, k0, e, f, g, rec, cap,
      nrec);
  return (int)cudaGetLastError();
}

}  // extern "C"
