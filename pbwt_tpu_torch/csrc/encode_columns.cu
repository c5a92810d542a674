// pack3 encoding of K1's sorted columns on the card: k1_encode_columns of
// pbwt_tpu_torch, and its inverse k1_decode_columns (see its note below).
//
// Replaces no TPU kernel: the JAX package downloads the sorted columns and
// encodes them on the host (pbwt_tpu/core/native.py, encode_cols), as the port
// did before (the columns unpacked to a byte a haplotype, then the host C
// runtime's p3_encode_cols). Here the columns stay on the card, packed as K1
// writes them (row i of a site at bit i % 32 of word i / 32; rows from m on,
// K1's all-ones pad rows, are cut off), and only the pack3 bytes cross to the
// host. The bytes are those of emit_run / p3_encode (csrc/pbwt_native.c) to
// the byte: a run of n rows of symbol y is a byte y << 7 | 0x7f for each whole
// 31 << 11 rows, then y << 7 | 0x60 | r >> 11 where the rest r is 2,048 or
// more, y << 7 | 0x40 | r >> 6 where what is left is 64 or more, and
// y << 7 | r for the last rows.
//
// Bound on the H100: bytes. The sites' ceil(m/32) words read once and the
// pack3 bytes written once: at 4,128 sites x 64,940 rows of a mosaic panel,
// 33.5 MB and 8.5 MB, 0.0126 ms at 3.35 TB/s. The operations are a few
// integer instructions a word and a few more a run (0.003 ms). The design
// reads the words twice, once a pass; they come straight from K1, which has
// just written them, and fit in the 50 MB L2, so both passes load them
// L2-only (__ldcg).
//
// Design: a warp a site, neighbouring sites in neighbouring warps. The warp
// walks the site in chunks of 128 words, a lane 4 consecutive words (one
// 16-byte load where the row pitch allows; the next chunk's load is issued
// before this one is used). No byte a haplotype is ever formed: the rows where
// a run starts are the set bits of each word XORed with itself shifted up by
// one row, the previous word's top bit carried in (from the lane below, or
// from the last chunk through a shuffle; row 0 starts no run of its own). A
// run is coded where it ends, at the next start p: it began at the start
// before p, its symbol is the complement of row p's bit, and its byte count
// follows emit_run's tiers. A lane's first run began at the last start of the
// lanes below it, or of an earlier chunk: a warp max scan of each lane's last
// start gives it. The last run of a site, to row m, is coded after the walk.
// A counting pass stores each site's byte count; the wrapper's scan over the
// sites gives the offsets, and a writing pass, which also scans the lanes'
// byte counts across the warp for their offsets within the site, writes the
// bytes. ops/build.py: encode_columns_plain is the plain twin.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int ENC_WARPS = 8;          // sites a block: a warp a site
constexpr int WPL = 4;                // consecutive words a lane of a chunk
constexpr int CHUNK = 32 * WPL;       // words of a site a chunk
constexpr unsigned FULL = 0xffffffffu;

// pack3 run lengths (pbwt_native.c: T1, T2, T3)
constexpr int P3_T1 = 64, P3_T2 = 32 << 6, P3_T3 = 31 << 11;

// emit_run's byte count for a run of n rows
__device__ __forceinline__ int run_bytes(int n) {
  const int q = n / P3_T3;
  const int r = n - q * P3_T3;
  return q + (r >= P3_T2) + ((r & 0x7ff) >= P3_T1) + ((r & 0x3f) != 0);
}

// emit_run: the bytes of a run of n rows of symbol sym at o; returns them
__device__ __forceinline__ int emit_run(unsigned sym, int n, unsigned char* o) {
  const unsigned top = sym << 7;
  int b = 0;
  while (n >= P3_T3) {
    o[b++] = (unsigned char)(top | 0x7fu);
    n -= P3_T3;
  }
  if (n >= P3_T2) {
    o[b++] = (unsigned char)(top | 0x60u | (unsigned)(n >> 11));
    n &= 0x7ff;
  }
  if (n >= P3_T1) {
    o[b++] = (unsigned char)(top | 0x40u | (unsigned)(n >> 6));
    n &= 0x3f;
  }
  if (n) o[b++] = (unsigned char)(top | (unsigned)n);
  return b;
}

// A lane's WPL words from word w0 of a site's row, 0 from word nw on.
// VEC: the row pitch and the base are multiples of 16 bytes and w0 of 4, so
// the four words are one 16-byte load inside the row.
template <bool VEC>
__device__ __forceinline__ void load_words(const unsigned* col, int w0, int nw, unsigned (&w)[WPL]) {
  if constexpr (VEC) {
    if (w0 < nw) {
      const uint4 v = __ldcg(reinterpret_cast<const uint4*>(col + w0));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else {
#pragma unroll
      for (int k = 0; k < WPL; ++k) w[k] = 0u;
    }
  } else {
#pragma unroll
    for (int k = 0; k < WPL; ++k) w[k] = w0 + k < nw ? __ldcg(col + w0 + k) : 0u;
  }
}

// A warp a site. Counting (WRITE false) stores the site's pack3 byte count in
// counts[site]; writing puts the bytes at offsets[site] of yz.
template <bool WRITE, bool VEC>
__global__ void __launch_bounds__(32 * ENC_WARPS)
    encode_columns_kernel(const unsigned* __restrict__ ycols, int n, int rw, int m,
                          int* __restrict__ counts, const long long* __restrict__ offsets,
                          unsigned char* __restrict__ yz) {
  const int lane = threadIdx.x & 31;
  const int site = blockIdx.x * ENC_WARPS + (threadIdx.x >> 5);
  if (site >= n) return;  // the whole warp
  const unsigned* col = ycols + (size_t)site * rw;
  const int nw = (m + 31) >> 5;  // the words that hold rows below m
  const unsigned tail = (m & 31) ? (1u << (m & 31)) - 1u : FULL;
  unsigned char* out = WRITE ? yz + offsets[site] : nullptr;
  int prev = 0;                 // the row where the open run started
  unsigned carry = col[0] & 1u; // the row before the chunk's first (row 0 at the start)
  int at = 0;                   // the site's bytes written before the chunk
  int mine = 0;                 // counting: the lane's bytes so far
  unsigned nxt[WPL];
  load_words<VEC>(col, WPL * lane, nw, nxt);
  for (int c0 = 0; c0 < nw; c0 += CHUNK) {
    const int w0 = c0 + WPL * lane;
    unsigned w[WPL], s[WPL];
#pragma unroll
    for (int k = 0; k < WPL; ++k) w[k] = nxt[k];
    if (c0 + CHUNK < nw) load_words<VEC>(col, w0 + CHUNK, nw, nxt);
    // the rows where runs start: a bit that differs from the row before it
    unsigned below = __shfl_up_sync(FULL, w[WPL - 1] >> 31, 1);
    if (lane == 0) below = carry;
    int last = -1;  // the lane's last start
#pragma unroll
    for (int k = 0; k < WPL; ++k) {
      s[k] = w[k] ^ ((w[k] << 1) | (k ? w[k - 1] >> 31 : below));
      if (w0 + k >= nw) s[k] = 0u;
      else if (w0 + k == nw - 1) s[k] &= tail;
      if (s[k]) last = 32 * (w0 + k) + 31 - __clz(s[k]);
    }
    // the start of the run open at the lane's first row: the last start of
    // the lanes below, or of the chunks before
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, last, d);
      if (lane >= d) last = max(last, v);
    }
    const int below_last = __shfl_up_sync(FULL, last, 1);
    const int first = lane ? max(prev, below_last) : prev;
    // the lane's runs, each coded at the start p that ends it
    int q = first, bytes = 0;
#pragma unroll
    for (int k = 0; k < WPL; ++k)
      for (unsigned b = s[k]; b; b &= b - 1) {
        const int p = 32 * (w0 + k) + __ffs(b) - 1;
        bytes += run_bytes(p - q);
        q = p;
      }
    if (WRITE) {
      int incl = bytes;  // the lanes' bytes up to this one
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += v;
      }
      int o = at + incl - bytes;
      q = first;
#pragma unroll
      for (int k = 0; k < WPL; ++k)
        for (unsigned b = s[k]; b; b &= b - 1) {
          const int bit = __ffs(b) - 1;
          const int p = 32 * (w0 + k) + bit;
          o += emit_run(((w[k] >> bit) & 1u) ^ 1u, p - q, out + o);
          q = p;
        }
      at += __shfl_sync(FULL, incl, 31);
    } else {
      mine += bytes;
    }
    prev = max(prev, __shfl_sync(FULL, last, 31));
    carry = __shfl_sync(FULL, w[WPL - 1] >> 31, 31);
  }
  // the site's last run, from prev to row m - 1, whose bit gives its symbol
  if (WRITE) {
    if (lane == 0) emit_run((col[nw - 1] >> ((m - 1) & 31)) & 1u, m - prev, out + at);
  } else {
#pragma unroll
    for (int d = 16; d; d >>= 1) mine += __shfl_xor_sync(FULL, mine, d);
    if (lane == 0) counts[site] = mine + run_bytes(m - prev);
  }
}

// ---------------------------------------------------------------------------
// k1_decode_columns: pack3 bytes into packed sorted columns on the card, the
// inverse of k1_encode_columns and the columns of p3_decode_cols
// (csrc/pbwt_native.c), a bit a row in K1's ycols layout (row i of a site at
// bit i % 32 of word i / 32, the rows from m on 0), which K2 reads.
//
// Replaces no TPU kernel: the JAX package decodes on the host
// (p3_decode_cols), as the port did before painting collected its matches
// on the card. A byte codes a run of rows of one symbol (its top bit) within
// one site: the encoder never lets a run cross a site's end. So a byte's
// first row, counted over the whole stream, gives its site and row, and the
// bytes are independent once those are known: a pass writes each byte's
// row count, the wrapper's scan over the bytes (torch's cumsum) gives the
// first rows, and a second pass, a thread a byte, writes the ones runs into
// the zeroed columns: words the run covers whole by plain stores, the words
// at its ends by atomicOr, as other runs share them. Bytes past the N sites'
// rows are not read, as p3_decode_cols stops after N sites; a byte that
// crosses a site's end, or a stream that ends before N sites, sets the error
// word (p3_decode_cols' -1), which the wrapper reads and raises on.
//
// Bound on the H100: bytes. A paint of 5,008 x 16,384 reads 5.9 MB of pack3
// and writes 10.3 MB of columns, a few microseconds at 3.35 TB/s; the row
// counts and first rows (12 B a byte) add 71 MB.

constexpr int DEC_THREADS = 256;

// emit_run's inverse: the rows of a pack3 byte (p3dec of pbwt_native.c)
__device__ __forceinline__ int byte_rows(unsigned b) {
  b &= 0x7fu;
  return b < 64u ? (int)b : b < 96u ? (int)(b - 64u) << 6 : (int)(b - 96u) << 11;
}

__global__ void __launch_bounds__(DEC_THREADS)
    decode_columns_kernel(const unsigned char* __restrict__ yz, long long nz, int nsites, int m,
                          int rw, int* __restrict__ rows, const long long* __restrict__ first,
                          unsigned* __restrict__ ycols, int* __restrict__ err) {
  const long long j = (long long)blockIdx.x * DEC_THREADS + threadIdx.x;
  if (j >= nz) return;
  const unsigned b = yz[j];
  const int n = byte_rows(b);
  if (!first) {
    rows[j] = n;
    return;
  }
  const long long at = first[j], total = (long long)nsites * m;
  if (j == nz - 1 && at + n < total) atomicExch(err, 1);  // the stream ends early
  if (at >= total) return;
  const int site = (int)(at / m), r0 = (int)(at - (long long)site * m);
  if (r0 + n > m) {  // a run across a site's end
    atomicExch(err, 1);
    return;
  }
  if (!(b >> 7) || !n) return;
  unsigned* col = ycols + (size_t)site * rw;
  const int r1 = r0 + n;  // one past the run's last row
  for (int w = r0 >> 5; w <= (r1 - 1) >> 5; ++w) {
    const int lo = max(r0 - 32 * w, 0), hi = min(r1 - 32 * w, 32);
    const unsigned mask = (hi == 32 ? FULL : (1u << hi) - 1u) & (FULL << lo);
    if (mask == FULL)
      col[w] = FULL;
    else
      atomicOr(col + w, mask);
  }
}

}  // namespace

extern "C" {

// pack3 bytes of n packed sorted columns: ycols holds n rows of rw int32
// words, row i of a site at bit i % 32 of word i / 32; rows m and on (rw * 32
// >= m) are not encoded. With offsets null: counts (n,) int32 takes each
// site's byte count. Else offsets (n,) int64, each site's first byte in yz
// (exclusive sums of the counts), and the bytes are written.
int k1_encode_columns(int device, const int* ycols, int n, int rw, int m, int* counts,
                      const long long* offsets, unsigned char* yz, void* stream) {
  if (n < 0 || m < 0 || (long long)rw * 32 < m) return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned* words = reinterpret_cast<const unsigned*>(ycols);
  const unsigned blocks = (unsigned)((n + ENC_WARPS - 1) / ENC_WARPS);
  const bool vec = rw % WPL == 0 && reinterpret_cast<uintptr_t>(ycols) % 16 == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (offsets) {
    auto kernel = vec ? encode_columns_kernel<true, true> : encode_columns_kernel<true, false>;
    kernel<<<blocks, 32 * ENC_WARPS, 0, st>>>(words, n, rw, m, counts, offsets, yz);
  } else {
    auto kernel = vec ? encode_columns_kernel<false, true> : encode_columns_kernel<false, false>;
    kernel<<<blocks, 32 * ENC_WARPS, 0, st>>>(words, n, rw, m, counts, offsets, yz);
  }
  return (int)cudaGetLastError();
}

// The columns of the first nsites sites of a pack3 stream of m rows a site:
// yz holds nz bytes. With first null: rows (nz,) int32 takes each byte's row
// count. Else first (nz,) int64, the rows before each byte (exclusive sums
// of the counts), and the ones runs are written into ycols (nsites rows of rw
// int32 words, rw * 32 >= m, zeroed by the caller); err (one int, zeroed)
// is set where the stream is not nsites sites of m rows.
int k1_decode_columns(int device, const unsigned char* yz, long long nz, int nsites, int m,
                      int rw, int* rows, const long long* first, int* ycols, int* err,
                      void* stream) {
  if (nz < 0 || nsites < 0 || m < 0 || (long long)rw * 32 < m) return (int)cudaErrorInvalidValue;
  if (nz == 0 || m == 0) return 0;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (nz + DEC_THREADS - 1) / DEC_THREADS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  decode_columns_kernel<<<(unsigned)blocks, DEC_THREADS, 0, (cudaStream_t)stream>>>(
      yz, nz, nsites, m, rw, rows, first, reinterpret_cast<unsigned*>(ycols), err);
  return (int)cudaGetLastError();
}

}  // extern "C"
