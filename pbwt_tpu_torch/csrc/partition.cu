// Stable PBWT column partitions on Hopper: kernels K1 and K2 of pbwt_tpu_torch,
// each one persistent launch over many sites.
//
// K1 k1_group_partition replaces the TPU group kernels of
// pbwt_tpu/ops/partition_pallas.py (group_partition_noa, group_partition_noa2,
// group_partition) together with the XLA two-sort gather and the stable u32
// sort around them (ops/build.py:_sort_gather, build_scan_pallas_noa*), and the
// per-group loop of build_scan_grouped. For every site of every 32-site group
// it partitions the prefix array a stably by the site's bit, and emits the
// site's sorted column packed 32 rows per word (bit i%32 of word i/32) and its
// zero count. The words stay in natural haplotype order: site 32t+s of the row
// at sort position i is bit s of W[t][a[i]] (or of a carried plane, regathered
// at s = 0, when the caller gives one).
//
// K2 k2_partition_ad_step replaces partition_ad_step and
// partition_ad_step_blocked and the per-site scan of match_jax.panel_trajectory:
// per site the stable partition of (a, d) by the site's bit, the divergence
// update of pbwtCursorForwardsAD (pbwtCore.c:485-508) as two segmented running
// maxima seeded with k+1 followed by d[0] = k+2, the exclusive zero-rank table
// u and the zero count. It reads and writes the trajectory tables themselves:
// site k reads A[k] and D[k-1] and writes A[k+1], D[k], U[k], C[k]. Its entry
// k2_partition_ad_columns takes the keys from packed sorted columns instead
// (the sharded build's replicated divergence, pbwt_tpu/parallel/sharding.py
// :79-91): site r's key of row i is bit i % 32 of word i / 32 of column r, so
// nothing is gathered through a; (a, d) ping-pong through two planes and no
// table, count or word is written. Its entry k2_partition_ad_table takes the
// same keys and writes every site's (a, d) as rows of two tables, which
// painting's within-panel match collection (csrc/max_within.cu) reads.
//
// Bound on the H100: the sites are a chain (site k+1 reads the order that site
// k scattered), and every plane of one site (0.3-3 MB at 65k-100k rows) lives
// in the 50 MB L2. The bytes (12-16 B a row a site) would take a fraction of a
// microsecond; what a site costs is latency: a load of the tile from L2, one
// exchange of tile summaries between the blocks, the scattered stores, and one
// grid barrier. Tensor cores, TMA and shared-memory tiling have nothing to do.
//
// Design: one cooperative launch whose blocks are all resident
// (occupancy x SMs caps the grid) steps through the sites together. Each block
// owns the row tiles b, b+G, b+2G, ... for the whole launch. Per site and tile:
//   1. load the rows once (16-byte loads, eight/four/two contiguous rows a
//      thread), summarise them (zeros; for K2 also "reset seen" and "maximum
//      since the reset" of the two divergence scans), scan the thread summaries
//      with warp shuffles, and publish the tile's summary as one 16-byte word
//      that carries the site's number as its stamp, so no fence stands between
//      data and flag and nothing is reset between sites;
//   2. wait for the stamps of the other tiles and combine their summaries in
//      tile order (combine is associative, not commutative): the total gives
//      the site's zero count, which every scatter needs, the part before the
//      own tile its carry-in. There is no scan kernel and no second pass over
//      the rows: with one tile a block they stay in registers;
//   3. scatter from registers: zeros to their rank, ones after the count;
//   4. one grid barrier (an atomic counter that only grows, a release add and
//      acquire loads) before the next site's loads.
// Every spin is capped and reports through an error word that the wrapper
// reads, so a fault is an exception, not a hang. Loads of planes that other
// blocks wrote go to L2 (__ldcg). Row offsets are int (n < 2^31 - 4096);
// offsets into the tables are size_t.
//
// k1_pack_columns packs a block's site columns into K1's group words on the
// card; see its note below.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_ITEMS = 2;       // fewest contiguous rows a thread
constexpr int HEADER_INTS = 8;     // scratch: barrier counter (2 ints), error word, pad
constexpr int REC_INTS = 4;        // a published tile summary, stamp included
constexpr int SPIN_CAP = 1 << 22;  // loads of a flag before a wait gives up
constexpr int ERR_BARRIER = 1, ERR_FLAG = 2;
constexpr int MAX_SITES = (1 << 29) - 1;  // a stamp has 30 bits of a summary's last word

// Summary of a run of rows in sort order: its zero count and, for each of the
// divergence scans, whether the run holds a reset and the running maximum of
// the seed since the last one. The p scan restarts after a zero, the q scan
// after a one (pbwtCore.c:489-503). K1 uses the zero count alone.
struct Sum {
  int z;
  int ph, pt;
  int qh, qt;
};

__device__ __forceinline__ Sum sum_identity() { return Sum{0, 0, INT_MIN, 0, INT_MIN}; }

// a precedes b. AD: with the divergence fields (K2); without, they stay at
// the identity and only the zero counts are added (K1).
template <bool AD>
__device__ __forceinline__ Sum combine(const Sum& a, const Sum& b) {
  Sum r = sum_identity();
  r.z = a.z + b.z;
  if constexpr (AD) {
    r.ph = a.ph | b.ph;
    r.pt = b.ph ? b.pt : max(a.pt, b.pt);
    r.qh = a.qh | b.qh;
    r.qt = b.qh ? b.qt : max(a.qt, b.qt);
  }
  return r;
}

template <bool AD>
__device__ __forceinline__ Sum shfl_up(const Sum& v, int off) {
  Sum r = sum_identity();
  r.z = __shfl_up_sync(0xffffffffu, v.z, off);
  if constexpr (AD) {
    r.ph = __shfl_up_sync(0xffffffffu, v.ph, off);
    r.pt = __shfl_up_sync(0xffffffffu, v.pt, off);
    r.qh = __shfl_up_sync(0xffffffffu, v.qh, off);
    r.qt = __shfl_up_sync(0xffffffffu, v.qt, off);
  }
  return r;
}

// Ordered scan over the block's threads: returns this thread's exclusive
// prefix, *total the combination of all. Every thread of the block calls it.
template <bool AD>
__device__ Sum block_scan(const Sum& mine, Sum* sh_warp, Sum* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Sum inc = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    Sum o = shfl_up<AD>(inc, off);
    if (lane >= off) inc = combine<AD>(o, inc);
  }
  Sum ex = shfl_up<AD>(inc, 1);
  if (lane == 0) ex = sum_identity();
  __syncthreads();  // the last call's readers of sh_warp are done
  if (lane == 31) sh_warp[warp] = inc;
  __syncthreads();
  Sum pre = sum_identity(), tot = sum_identity();
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    Sum x = sh_warp[w];
    if (w < warp) pre = combine<AD>(pre, x);
    tot = combine<AD>(tot, x);
  }
  *total = tot;
  return combine<AD>(pre, ex);
}

// A published tile summary is one 16-byte word, written and read whole (one
// st.v4 / ld.v4, a single transaction on this hardware), so the stamp arrives
// with the data and no fence or second read stands between them:
// {z, pt, qt, stamp << 2 | ph << 1 | qh}. The stamp is the site's number in
// the launch plus one; the scratch starts zeroed.
__device__ __forceinline__ void publish(int* recs, int j, const Sum& v, int stamp) {
  int* r = recs + (size_t)j * REC_INTS;
  asm volatile("st.relaxed.gpu.global.v4.s32 [%0], {%1, %2, %3, %4};" ::"l"(r), "r"(v.z), "r"(v.pt),
               "r"(v.qt), "r"((stamp << 2) | (v.ph << 1) | v.qh)
               : "memory");
}

// Wait for tile j's summary of this site. A wait that gives up (its own cap,
// or the error word another wait set) sets *bad.
__device__ __forceinline__ Sum wait_record(int* recs, int j, int stamp, int* err, bool* bad) {
  const int* r = recs + (size_t)j * REC_INTS;
  int x, y, z, w, spins = 0;
  for (;;) {
    asm volatile("ld.relaxed.gpu.global.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(x), "=r"(y), "=r"(z), "=r"(w)
                 : "l"(r)
                 : "memory");
    if ((w >> 2) == stamp) break;
    if (++spins > SPIN_CAP) {
      atomicExch(err, ERR_FLAG);
      *bad = true;
      break;
    }
    if ((spins & 255) == 0 && *reinterpret_cast<volatile int*>(err)) {
      *bad = true;
      break;
    }
  }
  return Sum{x, (w >> 1) & 1, y, w & 1, z};
}

// Combination, in tile order, of the published summaries lo..hi-1 (returned to
// every thread), and of lo..want-1 into *at_want (lo <= want <= hi). *failed
// is set, for the whole block alike, when a wait gave up.
template <bool AD>
__device__ Sum scan_records(int* recs, int lo, int hi, int want, int stamp, int* err,
                            Sum* sh_warp, Sum* sh_at, Sum* at_want, bool* failed) {
  Sum carry = sum_identity();
  bool bad = false;
  for (int base = lo; base < hi; base += THREADS) {
    int idx = base + threadIdx.x;
    Sum v = idx < hi ? wait_record(recs, idx, stamp, err, &bad) : sum_identity();
    Sum tot;
    Sum ex = block_scan<AD>(v, sh_warp, &tot);
    if (idx == want) *sh_at = combine<AD>(carry, ex);
    carry = combine<AD>(carry, tot);
  }
  *failed = __syncthreads_or(bad);
  *at_want = want < hi ? *sh_at : carry;
  return carry;
}

// All blocks of the (resident) grid arrive; the counter only grows, and the
// barrier after site r waits for (r+1) x blocks arrivals. Returns true, to
// the whole block alike, when the wait gave up (its own cap, or the error
// word another wait set).
__device__ bool grid_barrier(unsigned long long* bar, unsigned long long target, int* err,
                             int* sh_flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    // a release add and acquire loads, cheaper than a full fence on each side;
    // the block's stores are ordered before the add through the __syncthreads
    asm volatile("red.release.gpu.global.add.u64 [%0], 1;" ::"l"(bar) : "memory");
    int spins = 0, bad = 0;
    for (;;) {
      unsigned long long seen;
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(seen) : "l"(bar) : "memory");
      if (seen >= target) break;
      if (++spins > SPIN_CAP) {
        atomicExch(err, ERR_BARRIER);
        bad = 1;
        break;
      }
      if ((spins & 255) == 0 && *reinterpret_cast<volatile int*>(err)) {
        bad = 1;
        break;
      }
    }
    *sh_flag = bad;
  }
  __syncthreads();
  return *sh_flag != 0;
}

// ITEMS contiguous rows from a plane another block may have written: from L2,
// as 16-byte (8-byte at two rows) loads where the plane's row is aligned.
template <int ITEMS>
__device__ __forceinline__ void load_rows(const int* src, int i0, int nvalid, int (&out)[ITEMS]) {
  constexpr int V = ITEMS >= 4 ? 4 : 2;
  if (nvalid == ITEMS && (reinterpret_cast<uintptr_t>(src) & (4 * V - 1)) == 0) {
    if constexpr (ITEMS >= 4) {
#pragma unroll
      for (int q = 0; q < ITEMS / 4; ++q) {
        int4 x = __ldcg(reinterpret_cast<const int4*>(src + i0) + q);
        out[4 * q] = x.x;
        out[4 * q + 1] = x.y;
        out[4 * q + 2] = x.z;
        out[4 * q + 3] = x.w;
      }
    } else {
      int2 x = __ldcg(reinterpret_cast<const int2*>(src + i0));
      out[0] = x.x;
      out[1] = x.y;
    }
  } else {
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) out[t] = t < nvalid ? __ldcg(src + i0 + t) : 0;
  }
}

template <int ITEMS>
__device__ __forceinline__ void store_rows(int* dst, int i0, int nvalid, const int (&v)[ITEMS]) {
  constexpr int V = ITEMS >= 4 ? 4 : 2;
  if (nvalid == ITEMS && (reinterpret_cast<uintptr_t>(dst) & (4 * V - 1)) == 0) {
    if constexpr (ITEMS >= 4) {
#pragma unroll
      for (int q = 0; q < ITEMS / 4; ++q)
        reinterpret_cast<int4*>(dst + i0)[q] =
            make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
      *reinterpret_cast<int2*>(dst + i0) = make_int2(v[0], v[1]);
    }
  } else {
#pragma unroll
    for (int t = 0; t < ITEMS; ++t)
      if (t < nvalid) dst[i0 + t] = v[t];
  }
}

struct Params {
  int n, nsites;
  int s0;   // site r of the launch is bit (s0+r)%32 of word group (s0+r)/32
  int kk0;  // and global site kk0+r (the divergence values)
  // Site r reads a (and d) from in0 at r = 0, else from what site r-1 wrote:
  // plane (r % a_mod) of out, planes a_stride ints apart (a_mod = 2: ping-pong
  // scratch; a_mod = INT_MAX: the rows of a table).
  const int* a_in0;
  int* a_out;
  const int* d_in0;
  int* d_out;
  size_t a_stride;
  int a_mod;
  // Words: carried in sort order through the two planes of w_pp (w_in0 enters
  // site 0) when w_pp is given, and taken from the natural-order planes w_nat
  // through a where there is nothing carried or a new group begins.
  const int* w_in0;
  int* w_pp;
  size_t w_stride;
  const int* w_nat;
  size_t wn_stride;
  int* u_out;  // K2: table of exclusive zero ranks, rows a_stride apart, or null
  // K2 from packed sorted columns: site r's keys are the bits of the keys_rw
  // words at keys + r * keys_rw (in place of words)
  const unsigned* keys;
  int keys_rw;
  unsigned* ycols;  // K1: packed sorted columns, rw words a site
  int rw;
  int* counts;  // zero counts, a site each, or null (K2 from packed columns)
  int* scratch;
};

template <bool AD, int ITEMS>
struct Tile {
  int a[ITEMS], d[AD ? ITEMS : 1], w[ITEMS];
  unsigned keys;  // bit t: the site's bit of row t (0 beyond nvalid)
  int i0, nvalid;
};

template <bool AD, int ITEMS>
__device__ __forceinline__ void load_tile(Tile<AD, ITEMS>& t, int j, int n, int s, int kk,
                                          const int* a_src, const int* d_src, const int* w_src,
                                          const int* w_gat, const unsigned* keys) {
  t.i0 = j * (THREADS * ITEMS) + threadIdx.x * ITEMS;
  t.nvalid = min(max(n - t.i0, 0), ITEMS);
  load_rows<ITEMS>(a_src, t.i0, t.nvalid, t.a);
  if constexpr (AD) {
    load_rows<ITEMS>(d_src, t.i0, t.nvalid, t.d);
    if (t.i0 == 0 && t.nvalid > 0) t.d[0] = max(t.d[0], kk + 1);
  }
  if (keys) {
    // the ITEMS rows lie in one word: i0 is a multiple of ITEMS, which
    // divides 32; the column was written before the launch
    const unsigned word = t.nvalid > 0 ? __ldg(keys + (t.i0 >> 5)) : 0u;
    t.keys = (word >> (t.i0 & 31)) & ((1u << t.nvalid) - 1u);
    return;
  }
  if (w_gat) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) t.w[q] = q < t.nvalid ? __ldg(w_gat + t.a[q]) : 0;
  } else {
    load_rows<ITEMS>(w_src, t.i0, t.nvalid, t.w);
  }
  t.keys = 0;
#pragma unroll
  for (int q = 0; q < ITEMS; ++q)
    if (q < t.nvalid) t.keys |= (unsigned)((t.w[q] >> s) & 1) << q;
}

template <bool AD, int ITEMS>
__device__ __forceinline__ Sum thread_sum(const Tile<AD, ITEMS>& t) {
  Sum r = sum_identity();
  if constexpr (AD) {
#pragma unroll
    for (int q = 0; q < ITEMS; ++q) {
      if (q < t.nvalid) {
        int v = t.d[q];
        r.pt = max(r.pt, v);
        r.qt = max(r.qt, v);
        if ((t.keys >> q) & 1) {
          r.qh = 1;
          r.qt = INT_MIN;
        } else {
          r.z++;
          r.ph = 1;
          r.pt = INT_MIN;
        }
      }
    }
  } else {
    r.z = t.nvalid - __popc(t.keys);
  }
  return r;
}

// One persistent grid over p.nsites chained sites; see the file's header.
template <bool AD, int ITEMS>
__global__ void __launch_bounds__(THREADS) partition_sites(const Params p) {
  constexpr int TILE = THREADS * ITEMS;
  __shared__ Sum sh_warp[WARPS];
  __shared__ Sum sh_at;
  __shared__ int sh_flag;
  const int G = gridDim.x, b = blockIdx.x, n = p.n;
  const int nt = (n + TILE - 1) / TILE;
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(p.scratch);
  int* err = p.scratch + 2;
  int* recs = p.scratch + HEADER_INTS;

  Tile<AD, ITEMS> t;
  for (int r = 0; r < p.nsites; ++r) {
    const int s = (p.s0 + r) & 31, kk = p.kk0 + r, stamp = r + 1;
    const size_t from = (size_t)((r ? r - 1 : 0) % p.a_mod) * p.a_stride;
    const size_t to = (size_t)(r % p.a_mod) * p.a_stride;
    const int* a_src = r ? p.a_out + from : p.a_in0;
    int* a_dst = p.a_out + to;
    const int* d_src = nullptr;
    int* d_dst = nullptr;
    if constexpr (AD) {
      d_src = r ? p.d_out + from : p.d_in0;
      d_dst = p.d_out + to;
    }
    const int* w_src = r ? (p.w_pp ? p.w_pp + (size_t)((r - 1) & 1) * p.w_stride : nullptr)
                         : p.w_in0;
    int* w_dst = p.w_pp ? p.w_pp + (size_t)(r & 1) * p.w_stride : nullptr;
    const int* w_gat = (p.w_nat && (!w_src || s == 0))
                           ? p.w_nat + (size_t)((p.s0 + r) >> 5) * p.wn_stride
                           : nullptr;
    const unsigned* keys = p.keys ? p.keys + (size_t)r * p.keys_rw : nullptr;

    // 1. every own tile: load, summarise, publish
    Sum ex = sum_identity();
    int held = -1;  // the tile whose rows and prefix the registers hold
    for (int j = b; j < nt; j += G) {
      load_tile<AD, ITEMS>(t, j, n, s, kk, a_src, d_src, w_src, w_gat, keys);
      held = j;
      Sum tot;
      ex = block_scan<AD>(thread_sum<AD, ITEMS>(t), sh_warp, &tot);
      if constexpr (!AD) {
        // the sorted column: ITEMS bits a thread, 32 / ITEMS threads a word
        constexpr int PER = 32 / ITEMS;
        unsigned word = t.keys << ((threadIdx.x % PER) * ITEMS);
#pragma unroll
        for (int off = 1; off < PER; off <<= 1) word |= __shfl_xor_sync(0xffffffffu, word, off);
        int wi = t.i0 >> 5;
        if (threadIdx.x % PER == 0 && wi < p.rw) p.ycols[(size_t)r * p.rw + wi] = word;
      }
      if (threadIdx.x == 0) publish(recs, j, tot, stamp);
    }

    // 2. the site's zero count and the carry into the first own tile
    Sum run;
    bool failed;
    const int c = scan_records<AD>(recs, 0, nt, b, stamp, err, sh_warp, &sh_at, &run, &failed).z;
    if (failed) return;
    if (b == 0 && threadIdx.x == 0 && p.counts) p.counts[r] = c;

    // 3. scatter every own tile
    for (int j = b; j < nt; j += G) {
      if (j != b) {  // the tiles since this block's last one
        Sum unused;
        run = combine<AD>(run, scan_records<AD>(recs, j - G, j, j, stamp, err, sh_warp, &sh_at,
                                                &unused, &failed));
        if (failed) return;
      }
      if (j != held) {  // only a block with several tiles loads again
        load_tile<AD, ITEMS>(t, j, n, s, kk, a_src, d_src, w_src, w_gat, keys);
        held = j;
        Sum tot;
        ex = block_scan<AD>(thread_sum<AD, ITEMS>(t), sh_warp, &tot);
      }
      const Sum st = combine<AD>(run, ex);
      int zr = st.z, rp = st.pt, rq = st.qt;
      int u[AD ? ITEMS : 1];
#pragma unroll
      for (int q = 0; q < ITEMS; ++q) {
        if (q < t.nvalid) {
          const int i = t.i0 + q;
          int dst, dv = 0;
          if constexpr (AD) {
            u[q] = zr;
            rp = max(rp, t.d[q]);
            rq = max(rq, t.d[q]);
          }
          if ((t.keys >> q) & 1) {
            dst = c + (i - zr);
            if constexpr (AD) {
              dv = rq;
              rq = INT_MIN;
            }
          } else {
            dst = zr++;
            if constexpr (AD) {
              dv = rp;
              rp = INT_MIN;
            }
          }
          if ((unsigned)dst < (unsigned)n) {
            a_dst[dst] = t.a[q];
            if (w_dst) w_dst[dst] = t.w[q];
            if constexpr (AD) d_dst[dst] = dst == 0 ? kk + 2 : dv;
          }
        } else if constexpr (AD) {
          u[q] = 0;
        }
      }
      if constexpr (AD)
        if (p.u_out) store_rows<ITEMS>(p.u_out + (size_t)r * p.a_stride, t.i0, t.nvalid, u);
    }

    // 4. the next site reads what every block scattered
    if (r + 1 < p.nsites &&
        grid_barrier(bar, (unsigned long long)(r + 1) * (unsigned long long)G, err, &sh_flag))
      return;
  }
}

// Launches the kernel on a grid that is resident as a whole: at most
// occupancy x SMs blocks (and at most max_blocks, if positive), one a tile.
template <bool AD, int ITEMS>
int launch_sites(Params& p, int max_blocks, cudaStream_t st) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, partition_sites<AD, ITEMS>, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  long long cap = (long long)occ * sms;
  if (max_blocks > 0 && max_blocks < cap) cap = max_blocks;
  if (cap < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int tile = THREADS * ITEMS;
  long long nt = ((long long)p.n + tile - 1) / tile;
  int grid = (int)(nt < cap ? nt : cap);
  void* args[] = {&p};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(partition_sites<AD, ITEMS>), dim3(grid),
                                  dim3(THREADS), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Rows a thread when the caller leaves it open: the most (8, 4, 2) that still
// give every SM a tile, since a site is latency and not bytes.
int auto_items(int n, int sms) {
  for (int items = 8; items > MIN_ITEMS; items >>= 1)
    if (((long long)n + THREADS * items - 1) / (THREADS * items) >= sms) return items;
  return MIN_ITEMS;
}

template <bool AD>
int dispatch(Params& p, int items, int max_blocks, cudaStream_t st) {
  if (items == 0) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    items = auto_items(p.n, sms);
  }
  switch (items) {
    case 2: return launch_sites<AD, 2>(p, max_blocks, st);
    case 4: return launch_sites<AD, 4>(p, max_blocks, st);
    case 8: return launch_sites<AD, 8>(p, max_blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// k1_pack_columns: a block of natural-order site columns into K1's group words.
//
// It replaces the host pass of pbwt_tpu/ops/build.py:142 (pack_group_words),
// which no TPU kernel did: there, and in the port's BlockBuild before this
// kernel (ops/build.py:pack_column_words, numpy), the host packed a block and
// the words crossed to the device. Here the block crosses as its (n, M) bytes
// and is packed where K1 reads it. Site 32t+s of haplotype i becomes bit s of
// word [t][i]; a byte counts as 1 when it is not 0, as np.packbits counts it;
// rows M..Mp-1, and sites from n to the end of the last group, are ones.
//
// Bound on the H100: bytes. It reads the n*M bytes once and writes 4*Mp bytes
// a group (268 MB and 33.5 MB at 4,128 x 64,940: 0.090 ms at 3.35 TB/s) and
// does about 1.3 integer operations a hap-site (0.01 ms). So the design keeps
// every load coalesced and many in flight: a thread makes the words of 4
// neighbouring haplotypes of one group, reading its 32 sites as 4-byte loads
// (a warp's loads of one site are one 128-byte line), all 32 issued before one
// is used. The bytes are read once, so they are loaded evict-first (__ldcs) and
// the words, which K1 reads next, stay in the 50 MB L2. Each load's 4 bytes
// become 0x80 or 0 with an and, an add and an or; 8 sites gather in a register
// (byte j holds haplotype j's 8 bits), and eight byte permutes transpose the
// 4 x 4 bytes of the four registers into the four words, stored as one int4.
// M not a multiple of 4 (or a misaligned block) takes byte loads instead.

constexpr int PACK_THREADS = 256;
constexpr int PACK_GRID_Y = 65535;  // groups beyond it are looped over

// 0x80 in each byte of w that is not 0, and 0 in each byte that is
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (((w & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | w) & 0x80808080u;
}

// Bytes i0..i0+3 of a column, byte j of the result haplotype i0+j; 0xFF past m.
// VEC: m and the block's address are multiples of 4, so one load serves.
template <bool VEC>
__device__ __forceinline__ unsigned load_quad(const unsigned char* col, int i0, int m) {
  if constexpr (VEC) {
    return i0 < m ? __ldcs(reinterpret_cast<const unsigned*>(col + i0)) : 0xFFFFFFFFu;
  } else {
    unsigned v = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v |= (i0 + j < m ? (unsigned)__ldcs(col + i0 + j) : 0xFFu) << (8 * j);
    return v;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(PACK_THREADS)
    pack_columns(const unsigned char* __restrict__ cols, int n, int m, int* __restrict__ words,
                 int mp, int ngroups) {
  const int i0 = 4 * (blockIdx.x * PACK_THREADS + threadIdx.x);
  if (i0 >= mp) return;
  for (int t = blockIdx.y; t < ngroups; t += gridDim.y) {
    const int sites = min(32, n - 32 * t);
    const unsigned char* col = cols + (size_t)32 * t * m;
    unsigned v[32];
#pragma unroll
    for (int s = 0; s < 32; ++s)
      v[s] = s < sites ? load_quad<VEC>(col + (size_t)s * m, i0, m) : 0xFFFFFFFFu;
    // acc[q]'s byte j: haplotype i0+j at sites 8q..8q+7, site 8q+b at bit b
    unsigned acc[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int s = 0; s < 32; ++s) acc[s >> 3] = (acc[s >> 3] >> 1) | nonzero_bytes(v[s]);
    const unsigned lo0 = __byte_perm(acc[0], acc[1], 0x5140);
    const unsigned lo1 = __byte_perm(acc[0], acc[1], 0x7362);
    const unsigned hi0 = __byte_perm(acc[2], acc[3], 0x5140);
    const unsigned hi1 = __byte_perm(acc[2], acc[3], 0x7362);
    const int w[4] = {(int)__byte_perm(lo0, hi0, 0x5410), (int)__byte_perm(lo0, hi0, 0x7632),
                      (int)__byte_perm(lo1, hi1, 0x5410), (int)__byte_perm(lo1, hi1, 0x7632)};
    int* dst = words + (size_t)t * mp + i0;
    if ((mp & 3) == 0) {
      *reinterpret_cast<int4*>(dst) = make_int4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i0 + j < mp) dst[j] = w[j];
    }
  }
}

}  // namespace

extern "C" {

// Layout of the scratch the wrappers allocate (zeroed, once a launch):
// which = 1 the header's ints, 2 the ints of a tile summary, 3 the fewest rows
// of a tile; the scratch holds the header and a summary for each tile.
int pbwt_partition_layout(int which) {
  switch (which) {
    case 1: return HEADER_INTS;
    case 2: return REC_INTS;
    case 3: return THREADS * MIN_ITEMS;
    default: return -1;
  }
}

// K1 over ngroups 32-site groups in one launch. w_nat: ngroups planes of n
// natural-order words, wn_stride ints apart; a_in0: the prefix array entering
// the first group. a_pp: two planes of n ints; the final prefix array is left
// in plane 1. w_pp: two planes for the words carried in sort order (the final
// words in plane 1), or null to read every site's bit through a. ycols:
// ngroups*32 packed sorted columns of rw = ceil(n/32) words; counts: ngroups*32
// zero counts. items: rows a thread (8, 4, 2; 0 chooses); max_blocks: a cap on
// the grid (0: what the card holds).
int k1_group_partition(int device, const int* w_nat, long long wn_stride, const int* a_in0,
                       int n, int ngroups, int* a_pp, int* w_pp, int* ycols, int rw,
                       int* counts, int* scratch, int items, int max_blocks, void* stream) {
  if (n <= 0 || ngroups <= 0) return 0;
  if (n > INT_MAX - 4096 || ngroups > MAX_SITES / 32 || !w_nat) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.n = n;
  p.nsites = 32 * ngroups;
  p.a_in0 = a_in0;
  p.a_out = a_pp;
  p.a_stride = (size_t)n;
  p.a_mod = 2;
  p.w_pp = w_pp;
  p.w_stride = (size_t)n;
  p.w_nat = w_nat;
  p.wn_stride = (size_t)wn_stride;
  p.ycols = reinterpret_cast<unsigned*>(ycols);
  p.rw = rw;
  p.counts = counts;
  p.scratch = scratch;
  return dispatch<false>(p, items, max_blocks, (cudaStream_t)stream);
}

// The group words of n natural-order site columns of m bytes each (cols, row
// after row): words holds ceil(n/32) rows of mp >= m ints; see pack_columns.
int k1_pack_columns(int device, const unsigned char* cols, int n, int m, int* words, int mp,
                    void* stream) {
  if (n < 0 || m < 0 || mp < m) return (int)cudaErrorInvalidValue;
  if (n == 0 || mp == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (n + 31) / 32;
  const int quads = (mp + 3) / 4;
  const dim3 grid((quads + PACK_THREADS - 1) / PACK_THREADS,
                  ngroups < PACK_GRID_Y ? ngroups : PACK_GRID_Y);
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(cols) % 4 == 0;
  auto kernel = vec ? pack_columns<true> : pack_columns<false>;
  kernel<<<grid, PACK_THREADS, 0, (cudaStream_t)stream>>>(cols, n, m, words, mp, ngroups);
  return (int)cudaGetLastError();
}

// K2 over nsites chained sites in one launch: site r is bit (s0+r)%32 of word
// group (s0+r)/32 and global site kk0+r. a_in0, d_in0 enter site 0 (d without
// the d[M] sentinel); site r writes row r of a_out, d_out, u_out (rows
// row_stride ints apart) and counts[r], and reads rows r-1 of a_out and d_out:
// with a_out = A[1], d_out = D, u_out = U these are the trajectory tables.
// Words: w_in0 (in sort order) enters site 0 and w_pp (two planes of n ints)
// carries them, or w_nat (planes wn_stride apart) gives them in natural order;
// with both, w_nat is read where a group begins.
int k2_partition_ad_step(int device, const int* a_in0, const int* d_in0, const int* w_in0,
                         const int* w_nat, long long wn_stride, int n, int nsites, int s0,
                         int kk0, int* a_out, int* d_out, int* u_out, long long row_stride,
                         int* w_pp, int* counts, int* scratch, int items, int max_blocks,
                         void* stream) {
  if (n <= 0 || nsites <= 0) return 0;
  if (n > INT_MAX - 4096 || nsites > MAX_SITES ||
      (!w_nat && !(w_in0 && w_pp && nsites + (s0 & 31) <= 32)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.n = n;
  p.nsites = nsites;
  p.s0 = s0;
  p.kk0 = kk0;
  p.a_in0 = a_in0;
  p.a_out = a_out;
  p.d_in0 = d_in0;
  p.d_out = d_out;
  p.a_stride = (size_t)row_stride;
  p.a_mod = INT_MAX;
  p.w_in0 = w_in0;
  p.w_pp = w_pp;
  p.w_stride = (size_t)n;
  p.w_nat = w_nat;
  p.wn_stride = (size_t)wn_stride;
  p.u_out = u_out;
  p.counts = counts;
  p.scratch = scratch;
  return dispatch<true>(p, items, max_blocks, (cudaStream_t)stream);
}

// K2 over nsites chained sites in one launch, the keys from packed sorted
// columns: site r's key of row i is bit i % 32 of word i / 32 of the rw words
// at keys + r * rw (the layout of K1's ycols and the sharded build's
// sitewords). a_in0, d_in0 enter site 0 (d without the d[M] sentinel); site r
// is global site kk0 + r and writes plane r % 2 of a_pp and d_pp (two planes
// of n ints each), so the last site's (a, d) is plane (nsites - 1) % 2. No
// zero-rank table, count or word is written.
int k2_partition_ad_columns(int device, const int* keys, int rw, const int* a_in0,
                            const int* d_in0, int n, int nsites, int kk0, int* a_pp, int* d_pp,
                            int* scratch, int items, int max_blocks, void* stream) {
  if (n <= 0 || nsites <= 0) return 0;
  if (n > INT_MAX - 4096 || nsites > MAX_SITES || !keys || rw < (n + 31) / 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.n = n;
  p.nsites = nsites;
  p.kk0 = kk0;
  p.a_in0 = a_in0;
  p.a_out = a_pp;
  p.d_in0 = d_in0;
  p.d_out = d_pp;
  p.a_stride = (size_t)n;
  p.a_mod = 2;
  p.keys = reinterpret_cast<const unsigned*>(keys);
  p.keys_rw = rw;
  p.scratch = scratch;
  return dispatch<true>(p, items, max_blocks, (cudaStream_t)stream);
}

// K2 over nsites chained sites in one launch, the keys from packed sorted
// columns as k2_partition_ad_columns takes them, written as tables: site r
// is global site kk0 + r, reads row r of a_tab and d_tab (rows n ints apart)
// and writes row r + 1, so that row r holds (a, d) before site kk0 + r (d
// without the d[n] sentinel; row 0 is the caller's). No zero-rank table,
// count or word is written. items, max_blocks: the launch's rows a thread
// and cap on its grid, as the other entries take them (0: chosen there).
int k2_partition_ad_table(int device, const int* keys, int rw, int* a_tab, int* d_tab, int n,
                          int nsites, int kk0, int* scratch, int items, int max_blocks,
                          void* stream) {
  if (n <= 0 || nsites <= 0) return 0;
  if (n > INT_MAX - 4096 || nsites > MAX_SITES || !keys || rw < (n + 31) / 32)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Params p = {};
  p.n = n;
  p.nsites = nsites;
  p.kk0 = kk0;
  p.a_in0 = a_tab;
  p.a_out = a_tab + n;
  p.d_in0 = d_tab;
  p.d_out = d_tab + n;
  p.a_stride = (size_t)n;
  p.a_mod = INT_MAX;
  p.keys = reinterpret_cast<const unsigned*>(keys);
  p.keys_rw = rw;
  p.scratch = scratch;
  return dispatch<true>(p, items, max_blocks, (cudaStream_t)stream);
}

}  // extern "C"
