// The output stage of reference imputation on the card: kernel K8 of
// pbwt_tpu_torch (k8_sums, k8_chain, k8_encode).
//
// Replaces no TPU kernel: the JAX package downloads the vote's results and
// runs this stage on the host (pbwt_tpu/algos/impute.py, _vote_sums and the C
// pass impute_emit), as the port did before. Here K5's (T, Nref) results stay
// on the card and only what the imputed panel holds crosses to the host: the
// pack3 alleles yz, the dosage stream with each site's offset, the final
// prefix array and four sums a site for the info scores, a few MB in place of
// 655 MB. Everything is the host's to the byte and to the bit (csrc/
// pbwt_native.c: impute_emit, emit_run, dos_emit, dos_sym, fwd_a).
//
// k8_sums: a thread a reference site, the targets in order, neighbouring
// threads on neighbouring sites (coalesced reads of the (T, Nref) rows). It
// adds the site's vote count, sum of dosages, sum of alleles and sum of
// dosage x allele over the targets that voted, in target order, as numpy's
// axis-0 sums add the rows, so the f64 sums keep their bits; and writes a
// code byte a (site, target), allele << 3 | the dosage's 6-level symbol,
// site-major, 16 targets a 16-byte store. The symbol is the host's
// (int)(10.0 * (dd + 0.0999999)) with each operation rounded on its own.
// Bound: bytes, 10 B a (target, site) read and 1 written.
//
// k8_chain: one block walks the sites in order, as the PBWT's prefix arrays
// depend each on the last. Where the block's shared memory holds the prefix
// array a (uint16, up to 32 positions a thread of 1,024) and two code rows
// (T bytes each, a pitch of a multiple of 16), a stays there and each site's
// row is brought ahead by the copy engine (cp.async.bulk into a ring of 2
// rows, an mbarrier a slot). A thread holds PER consecutive positions: it
// gathers their codes through a into sort order, stores them as the site's
// sorted row, and the block stable-partitions a by the allele bit (each
// thread's count of zeros, its warp's scan of them as a ballot a bit of the
// count, the warps' totals read back from shared memory) exactly as fwd_a
// does. Reads of a all happen before the site's first barrier and its writes
// after it, so a needs one buffer. Past that (more targets than the block's
// positions or its shared memory), k8_chain_wide: a (int32) in global memory,
// two buffers, the row read where it lies (both stay in the L2 up to
// millions of targets), the positions in tiles of the block's; a first pass
// gathers each tile, stores its sorted row and counts the zeros, a second
// reads the tile's own codes back and writes the partition into the other
// buffer, the zeros of earlier tiles carried. Bound: the chain, two block
// barriers a site (and one a tile wide), not bytes.
//
// k8_encode: a thread a site again, over the sorted rows: the pack3 bytes of
// the allele's runs (emit_run) and the dosage stream's bytes of the symbols'
// runs (dos_emit, with its escapes for zero runs of 2^5, 2^10 and 2^15 and
// more). A count pass gives each site's two byte counts; the wrapper's scan
// over sites gives the offsets; a write pass writes both streams. Bound:
// bytes, the sorted rows read once (twice: count and write).
//
// ops/impute.py: vote_sums_plain, sort_codes_plain and encode_rows_plain are
// the plain twins.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SUM_THREADS = 128;   // sites a block of k8_sums
constexpr int GROUP = 16;          // targets a 16-byte store of codes
constexpr int ENC_THREADS = 128;   // sites a block of k8_encode
constexpr int CHAIN_MAX_THREADS = 1024;
constexpr int SLOTS = 2;           // rows of the ring
constexpr int WIDE_PER = 8;        // positions a thread of k8_chain_wide
constexpr int ALIGN = 16;          // the code rows' pitch and the bulk copies
// shared memory of the chain block before the prefix array: the slots'
// barriers, then the warps' totals
constexpr int CHAIN_FIXED = 8 * SLOTS + 4 * 32;
constexpr unsigned FULL = 0xffffffffu;

// pack3 run lengths (pbwt_native.c: T1, T2, T3)
constexpr long P3_T1 = 64, P3_T2 = 32 << 6, P3_T3 = 31 << 11;

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem(bar)), "r"(count)
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

// The wait for a barrier's phase of this parity to complete; a wait that
// outlasts WAIT_CAP tries traps, so that a fault fails the launch instead of
// hanging the card.
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

// dosageEncode (pbwtImpute.c:1631-1641), each operation rounded on its own
__device__ __forceinline__ unsigned dos_sym(double d) {
  const double dd = d > 0.5 ? __dsub_rn(1.0, d) : d;
  return dd == 0.0 ? 0u : (unsigned)__double2int_rz(__dmul_rn(10.0, __dadd_rn(dd, 0.0999999)));
}

__global__ void __launch_bounds__(SUM_THREADS)
k8_sums_kernel(const double* __restrict__ dosage, const unsigned char* __restrict__ x,
               const unsigned char* __restrict__ voted, int nt, int nref, int pitch,
               double* __restrict__ sums, unsigned char* __restrict__ codes) {
  const int k = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (k >= nref) return;
  unsigned nvote = 0, xsum = 0;
  double psum = 0.0, pxsum = 0.0;
  for (int t0 = 0; t0 < nt; t0 += GROUP) {
    double d[GROUP];
    unsigned char xv[GROUP], vv[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const size_t at = (size_t)(t0 + j) * nref + k;
      const bool in = t0 + j < nt;
      d[j] = in ? dosage[at] : 0.0;
      xv[j] = in ? x[at] : 0;
      vv[j] = in ? voted[at] : 0;
    }
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      const bool v = vv[j] != 0, a = xv[j] != 0;
      nvote += v;
      xsum += v && a;
      psum = __dadd_rn(psum, v ? d[j] : 0.0);
      pxsum = __dadd_rn(pxsum, v && a ? d[j] : 0.0);
      w[j >> 2] |= ((unsigned)a << 3 | dos_sym(d[j])) << (8 * (j & 3));
    }
    // past nt: code 0, the pitch's padding
    *reinterpret_cast<uint4*>(codes + (size_t)k * pitch + t0) = make_uint4(w[0], w[1], w[2], w[3]);
  }
  sums[k] = (double)nvote;
  sums[nref + k] = psum;
  sums[2 * (size_t)nref + k] = (double)xsum;
  sums[3 * (size_t)nref + k] = pxsum;
}

// The chain block: PER positions a thread, the prefix array and a ring of
// SLOTS rows in shared memory.
template <int PER>
__global__ void __launch_bounds__(CHAIN_MAX_THREADS)
k8_chain_kernel(const unsigned char* __restrict__ codes, int nt, int nref, int pitch,
                unsigned char* __restrict__ sorted, int* __restrict__ a_end) {
  extern __shared__ __align__(128) unsigned char sm[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(sm);
  int* tot = reinterpret_cast<int*>(sm + 8 * SLOTS);
  unsigned short* a = reinterpret_cast<unsigned short*>(sm + CHAIN_FIXED);
  unsigned char* ring = sm + CHAIN_FIXED + 2 * pitch;  // 16-byte aligned: pitch % 16 == 0
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int base = tid * PER;

  for (int i = tid; i < nt; i += blockDim.x) a[i] = (unsigned short)i;
  if (tid < SLOTS) bar_init(&bars[tid], 1);
  __syncthreads();
  if (tid == 0) {
    for (int r = 0; r < SLOTS && r < nref; ++r) {
      bar_arrive_expect(&bars[r], pitch);
      copy_bulk(ring + (size_t)r * pitch, codes + (size_t)r * pitch, pitch, &bars[r]);
    }
  }

  for (int k = 0; k < nref; ++k) {
    const int slot = k % SLOTS;
    bar_wait(&bars[slot], (unsigned)(k / SLOTS) & 1u);
    const unsigned char* row = ring + (size_t)slot * pitch;

    // gather this thread's positions into sort order
    unsigned av[PER / 2], yw[PER / 4], zeros = 0u;
#pragma unroll
    for (int q = 0; q < PER / 8; ++q) {
      const uint4 v = base + 8 * q < nt ? *reinterpret_cast<const uint4*>(a + base + 8 * q)
                                        : make_uint4(0u, 0u, 0u, 0u);
      av[4 * q] = v.x;
      av[4 * q + 1] = v.y;
      av[4 * q + 2] = v.z;
      av[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const unsigned ai = (av[e >> 1] >> (16 * (e & 1))) & 0xffffu;
      const bool in = base + e < nt;
      const unsigned y = in ? row[ai] : 0u;
      if (e % 4 == 0) yw[e >> 2] = 0u;
      yw[e >> 2] |= y << (8 * (e & 3));
      zeros |= (unsigned)(in && !(y & 8u)) << e;
    }
    // the sorted row, 16 bytes a store where it lies inside the pitch
    unsigned char* out = sorted + (size_t)k * pitch + base;
    if (PER == 8) {
      if (base < pitch) *reinterpret_cast<uint2*>(out) = make_uint2(yw[0], yw[1]);
    } else {
#pragma unroll
      for (int c = 0; c < PER / 16; ++c)
        if (base + 16 * c < pitch)
          *reinterpret_cast<uint4*>(out + 16 * c) =
              make_uint4(yw[4 * c], yw[4 * c + 1], yw[4 * c + 2], yw[4 * c + 3]);
    }

    // the block's exclusive scan of the zeros: in the warp a ballot a bit of
    // the thread's count (at most PER), then the warps' totals
    const int c = __popc(zeros);
    const unsigned lt = (1u << lane) - 1u;
    int before = 0, wsum = 0;
#pragma unroll
    for (int b = 0; (1 << b) <= PER; ++b) {
      const unsigned m = __ballot_sync(FULL, (c >> b) & 1);
      before += __popc(m & lt) << b;
      wsum += __popc(m) << b;
    }
    if (lane == 0) tot[warp] = wsum;
    __syncthreads();  // the totals are in; every read of a and of the row is done

    // the slot is free: the row SLOTS sites on goes into it
    if (tid == 0 && k + SLOTS < nref) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_arrive_expect(&bars[slot], pitch);
      copy_bulk(ring + (size_t)slot * pitch, codes + (size_t)(k + SLOTS) * pitch, pitch,
                &bars[slot]);
    }
    int nzero = 0;
    for (int w = 0; w < nwarps; w += 4) {  // the totals past nwarps are not used
      const int4 t = *reinterpret_cast<const int4*>(tot + w);
      const int u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int uj = w + j < nwarps ? u[j] : 0;
        nzero += uj;
        before += w + j < warp ? uj : 0;
      }
    }

    // stable partition: zeros in order, then ones in order
#pragma unroll
    for (int e = 0; e < PER; ++e) {
      const int i = base + e;
      if (i < nt) {
        const int zb = before + __popc(zeros & ((1u << e) - 1u));
        const int dest = (zeros >> e) & 1u ? zb : nzero + (i - zb);
        a[dest] = (unsigned short)((av[e >> 1] >> (16 * (e & 1))) & 0xffffu);
      }
    }
    __syncthreads();  // a is the next site's
  }
  for (int i = tid; i < nt; i += blockDim.x) a_end[i] = a[i];
}

// The wide chain: WIDE_PER positions a thread, in tiles of the block's
// positions; the prefix array in global memory, buffers a0 and a0 + pitch.
__global__ void __launch_bounds__(CHAIN_MAX_THREADS)
k8_chain_wide_kernel(const unsigned char* __restrict__ codes, int nt, int nref, int pitch,
                     int* a0, unsigned char* __restrict__ sorted, int* __restrict__ a_end) {
  constexpr int PER = WIDE_PER;
  __shared__ __align__(16) int tot[2][32];  // the warps' totals, a tile's parity
  __shared__ __align__(16) int zsum[32];   // the warps' zeros over the site
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int tile = blockDim.x * PER;
  const unsigned lt = (1u << lane) - 1u;

  for (int i = tid; i < nt; i += blockDim.x) a0[i] = i;
  __syncthreads();
  for (int k = 0; k < nref; ++k) {
    // not restrict: the block writes both buffers, a site each
    const int* cur = a0 + (size_t)(k & 1) * pitch;
    int* nxt = a0 + (size_t)((k & 1) ^ 1) * pitch;
    const unsigned char* row = codes + (size_t)k * pitch;
    unsigned char* out = sorted + (size_t)k * pitch;

    // the gather into sort order, the sorted row, the count of zeros
    int c = 0;
    for (int base = tid * PER; base < pitch; base += tile) {
      const int4 v0 = *reinterpret_cast<const int4*>(cur + base);
      const int4 v1 = *reinterpret_cast<const int4*>(cur + base + 4);
      const int av[PER] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      unsigned yw[2] = {0u, 0u};
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const bool in = base + e < nt;
        const unsigned y = in ? row[av[e]] : 0u;
        yw[e >> 2] |= y << (8 * (e & 3));
        c += in && !(y & 8u);
      }
      // past nt: code 0, the pitch's padding (base + PER <= pitch)
      *reinterpret_cast<uint2*>(out + base) = make_uint2(yw[0], yw[1]);
    }
    c = __reduce_add_sync(FULL, c);
    if (lane == 0) zsum[warp] = c;
    __syncthreads();
    int nzero = 0;
    for (int w = 0; w < nwarps; ++w) nzero += zsum[w];

    // the stable partition, a tile at a time: each thread reads back its own
    // codes, the block scans the zeros, the earlier tiles' carried in `run`
    int run = 0;
    for (int t0 = 0, p = 0; t0 < nt; t0 += tile, p ^= 1) {
      const int base = t0 + tid * PER;
      unsigned zeros = 0u;
      int av[PER];
      if (base < nt) {
        const uint2 y = *reinterpret_cast<const uint2*>(out + base);
        const int4 v0 = *reinterpret_cast<const int4*>(cur + base);
        const int4 v1 = *reinterpret_cast<const int4*>(cur + base + 4);
        av[0] = v0.x, av[1] = v0.y, av[2] = v0.z, av[3] = v0.w;
        av[4] = v1.x, av[5] = v1.y, av[6] = v1.z, av[7] = v1.w;
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          const unsigned ye = ((e < 4 ? y.x : y.y) >> (8 * (e & 3))) & 0xffu;
          zeros |= (unsigned)(base + e < nt && !(ye & 8u)) << e;
        }
      }
      const int cnt = __popc(zeros);
      int before = 0, wsum = 0;
#pragma unroll
      for (int b = 0; (1 << b) <= PER; ++b) {
        const unsigned m = __ballot_sync(FULL, (cnt >> b) & 1);
        before += __popc(m & lt) << b;
        wsum += __popc(m) << b;
      }
      if (lane == 0) tot[p][warp] = wsum;
      __syncthreads();  // the tile's totals are in
      int ttot = 0;
      for (int w = 0; w < nwarps; ++w) {
        const int u = tot[p][w];
        ttot += u;
        before += w < warp ? u : 0;
      }
      if (base < nt) {
#pragma unroll
        for (int e = 0; e < PER; ++e) {
          const int i = base + e;
          if (i < nt) {
            const int zb = run + before + __popc(zeros & ((1u << e) - 1u));
            nxt[(zeros >> e) & 1u ? zb : nzero + (i - zb)] = av[e];
          }
        }
      }
      run += ttot;
    }
    __syncthreads();  // nxt is the next site's
  }
  const int* last = a0 + (size_t)(nref & 1) * pitch;
  for (int i = tid; i < nt; i += blockDim.x) a_end[i] = last[i];
}

// emit_run of pbwt_native.c: the pack3 bytes of a run of n symbols `sym`,
// written from o[at] when WRITE; returns their count
template <bool WRITE>
__device__ __forceinline__ int emit_run(unsigned sym, long n, unsigned char* o, int at) {
  if (WRITE) o += at;
  const unsigned top = sym << 7;
  int b = 0;
  while (n >= P3_T3) {
    if (WRITE) o[b] = (unsigned char)(top | 0x7fu);
    ++b;
    n -= P3_T3;
  }
  if (n >= P3_T2) {
    if (WRITE) o[b] = (unsigned char)(top | 0x60u | (unsigned)(n >> 11));
    ++b;
    n &= 0x7ff;
  }
  if (n >= P3_T1) {
    if (WRITE) o[b] = (unsigned char)(top | 0x40u | (unsigned)(n >> 6));
    ++b;
    n &= 0x3f;
  }
  if (n) {
    if (WRITE) o[b] = (unsigned char)(top | (unsigned)n);
    ++b;
  }
  return b;
}

// dos_emit of pbwt_native.c (dosageStore, pbwtImpute.c:1643-1657)
template <bool WRITE>
__device__ __forceinline__ int dos_emit(unsigned d, long n, unsigned char* o, int at) {
  if (WRITE) o += at;
  int b = 0;
  if (d == 0) {
    while (n >= (1L << 15)) {
      if (WRITE) o[b] = 0xff;
      ++b;
      n -= 31L << 10;
    }
    if (n >= (1L << 10)) {
      if (WRITE) o[b] = (unsigned char)((7u << 5) | (unsigned)(n >> 10));
      ++b;
      n &= 1023;
    }
    if (n >= (1L << 5)) {
      if (WRITE) o[b] = (unsigned char)((6u << 5) | (unsigned)(n >> 5));
      ++b;
      n &= 31;
    }
    if (WRITE) o[b] = (unsigned char)n;
    return b + 1;
  }
  while (n >= (1L << 5)) {
    if (WRITE) o[b] = (unsigned char)((d << 5) | 31u);
    ++b;
    n -= 31;
  }
  if (WRITE) o[b] = (unsigned char)((d << 5) | (unsigned)n);
  return b + 1;
}

// A thread a site: the runs of its sorted row's alleles and dosage symbols.
// Counting (WRITE false) stores the two byte counts in counts[k] and
// counts[nref + k]; writing puts the bytes at offsets[k] of yz and
// offsets[nref + k] of zd.
template <bool WRITE>
__global__ void __launch_bounds__(ENC_THREADS)
k8_encode_kernel(const unsigned char* __restrict__ sorted, int nt, int nref, int pitch,
                 int* __restrict__ counts, const long long* __restrict__ offsets,
                 unsigned char* __restrict__ yz, unsigned char* __restrict__ zd) {
  const int k = blockIdx.x * ENC_THREADS + threadIdx.x;
  if (k >= nref) return;
  const unsigned char* row = sorted + (size_t)k * pitch;
  unsigned char* yo = nullptr;
  unsigned char* zo = nullptr;
  if (WRITE) {
    yo = yz + offsets[k];
    zo = zd + offsets[nref + k];
  }
  int ny = 0, nd = 0;
  unsigned ca = (row[0] >> 3) & 1u, cs = row[0] & 7u;
  long ra = 0, rs = 0;
  for (int t0 = 0; t0 < nt; t0 += 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(row + t0);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (t0 + j >= nt) break;
      const unsigned y = (w[j >> 2] >> (8 * (j & 3))) & 0xffu;
      const unsigned al = (y >> 3) & 1u, s = y & 7u;
      if (al != ca) {
        ny += emit_run<WRITE>(ca, ra, yo, ny);
        ca = al;
        ra = 0;
      }
      ++ra;
      if (s != cs) {
        nd += dos_emit<WRITE>(cs, rs, zo, nd);
        cs = s;
        rs = 0;
      }
      ++rs;
    }
  }
  ny += emit_run<WRITE>(ca, ra, yo, ny);
  nd += dos_emit<WRITE>(cs, rs, zo, nd);
  if (!WRITE) {
    counts[k] = ny;
    counts[nref + k] = nd;
  }
}

}  // namespace

extern "C" {

// K8's sums. dosage (nt, nref) f64, x and voted (nt, nref) uint8: K5's
// outputs. Writes sums (4, nref) f64: each site's count of targets that
// voted, their sum of dosages, of alleles and of dosage x allele, added in
// target order; codes (nref, pitch) uint8, pitch a multiple of 16 at least
// nt: x << 3 | the dosage's symbol, 0 past nt.
int k8_sums(int device, const double* dosage, const unsigned char* x, const unsigned char* voted,
            int nt, int nref, int pitch, double* sums, unsigned char* codes, void* stream) {
  if (nt <= 0 || nref <= 0) return 0;
  if (pitch < nt || pitch % ALIGN || (uintptr_t)codes % ALIGN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  k8_sums_kernel<<<(nref + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0,
                   (cudaStream_t)stream>>>(dosage, x, voted, nt, nref, pitch, sums, codes);
  return (int)cudaGetLastError();
}

// K8's chain: one block of `threads` threads, `per` (8, 16 or 32)
// positions a thread; nt and nref at least 1. codes (nref, pitch) uint8 as
// k8_sums writes them, 16-byte aligned. With `prefix` null, the prefix array
// and a ring of 2 rows in shared memory: threads * per >= nt, nt < 65,536.
// Else k8_chain_wide, per 8, any nt: prefix (2, pitch) int32, 16-byte
// aligned, the prefix array's two buffers. Writes sorted (nref, pitch): each
// site's codes in the site's sort order (the prefix array from the identity,
// advanced by each site's allele bit as fwd_a does), 0 past nt; a_end (nt,)
// int32 the last prefix array.
int k8_chain(int device, const unsigned char* codes, int nt, int nref, int pitch, int per,
             int threads, int* prefix, unsigned char* sorted, int* a_end, void* stream) {
  const bool wide = prefix != nullptr;
  if (nt <= 0 || nref <= 0 || pitch < nt || pitch % ALIGN || (uintptr_t)codes % ALIGN ||
      (uintptr_t)sorted % ALIGN || threads % 32 || threads < 32 || threads > CHAIN_MAX_THREADS ||
      (wide ? per != WIDE_PER || (uintptr_t)prefix % ALIGN
            : nt > 65535 || (long)threads * per < nt))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (wide) {
    k8_chain_wide_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(codes, nt, nref, pitch, prefix,
                                                                   sorted, a_end);
    return (int)cudaGetLastError();
  }
  const size_t bytes = CHAIN_FIXED + 2 * (size_t)pitch + (size_t)SLOTS * pitch;
  void (*kernel)(const unsigned char*, int, int, int, unsigned char*, int*) =
      per == 8 ? k8_chain_kernel<8> : per == 16 ? k8_chain_kernel<16>
                                    : per == 32 ? k8_chain_kernel<32> : nullptr;
  if (!kernel) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, threads, bytes, (cudaStream_t)stream>>>(codes, nt, nref, pitch, sorted, a_end);
  return (int)cudaGetLastError();
}

// K8's coding. sorted (nref, pitch) as k8_chain writes it. With offsets
// null: counts (2, nref) int32 takes each site's pack3 bytes, then its
// dosage bytes. Else offsets (2, nref) int64, each site's first byte in yz
// and in zd (exclusive sums of the counts), and both streams are written.
int k8_encode(int device, const unsigned char* sorted, int nt, int nref, int pitch, int* counts,
              const long long* offsets, unsigned char* yz, unsigned char* zd, void* stream) {
  if (nt <= 0 || nref <= 0) return 0;
  if (pitch < nt || pitch % ALIGN || (uintptr_t)sorted % ALIGN) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (nref + ENC_THREADS - 1) / ENC_THREADS;
  if (offsets)
    k8_encode_kernel<true><<<blocks, ENC_THREADS, 0, (cudaStream_t)stream>>>(
        sorted, nt, nref, pitch, counts, offsets, yz, zd);
  else
    k8_encode_kernel<false><<<blocks, ENC_THREADS, 0, (cudaStream_t)stream>>>(
        sorted, nt, nref, pitch, counts, offsets, yz, zd);
  return (int)cudaGetLastError();
}

// The chain block's layout for the wrapper: 1 the shared bytes before the
// prefix array, 2 the rows of the ring, 3 the most threads, 4 the positions
// a thread of k8_chain_wide.
int k8_layout(int what) {
  return what == 1 ? CHAIN_FIXED : what == 2 ? SLOTS : what == 3 ? CHAIN_MAX_THREADS
       : what == 4 ? WIDE_PER : -1;
}

}  // extern "C"
