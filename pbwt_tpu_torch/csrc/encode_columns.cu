// pack3 encoding of K1's sorted columns on the card: k1_encode_columns of
// pbwt_tpu_torch.
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

}  // extern "C"
