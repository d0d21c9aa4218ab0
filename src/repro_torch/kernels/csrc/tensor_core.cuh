// Tensor-core building blocks shared by the bf16 attention kernels
// (flash_attention.cu, flash_attention_bwd.cu), for sm_90a.
//
// mma.sync.m16n8k16 (bf16 in, float32 sums) with operands fetched from
// shared memory by ldmatrix, 16-byte cp.async copies from device memory to
// shared memory, and the tile loader and mask tests the kernels share.
// Fragment layouts (PTX ISA, "mma.m16n8k16"), for lane l, g = l / 4,
// c = l % 4:
//   A (16 x 16, row-major): a0 = (g, 2c..2c+1), a1 = (g + 8, 2c..),
//     a2 = (g, 2c + 8..), a3 = (g + 8, 2c + 8..)
//   B (16 x 8, k x n):      b0 = (k 2c..2c+1, n g), b1 = (k 2c + 8.., n g)
//   C (16 x 8, float32):    c0, c1 = (g, 2c..2c+1), c2, c3 = (g + 8, 2c..)
// so the C tiles of two adjacent 8-column blocks are, packed to bf16 pairs,
// the A tile of one 16-deep step (as flash-attention-2 does).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace repro_tc {

using bf16 = __nv_bfloat16;

enum Kind { kCausal = 0, kWindow = 1, kChunk = 2, kBidir = 3 };
// how a mask meets a tile of (query, key) pairs: no pair admitted, every
// pair, only the causal diagonal or the Sq / Sk tail crosses it, or a
// window or chunk edge crosses it
enum TileClass { kNone = 0, kFull = 1, kEdge = 2, kPartial = 3 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory, asynchronously; the first
// src_bytes (0 or 16) are read, the rest zero-filled.  dst and src 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
// 4 bytes, the same way (float statistics, 4-byte aligned).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8 x 8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b, one m16n8k16 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile
// with rows of ld elements
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int r0, int k0, int lane) {
  ldsm_x4(a, tile + (r0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}
// B fragments of two 8-column blocks for x . rows^T: rows n0..n0+15 of a
// row-major tile are the columns, k0..k0+15 the depth.  b[0], b[1] are
// block n0's b0, b1; b[2], b[3] block n0 + 8's.
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const bf16* tile, int ld, int n0,
                                            int k0, int lane) {
  ldsm_x4(b, tile + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 +
                 ((lane / 8) % 2) * 8);
}
// B fragments of two 8-column blocks for x . tile: rows k0..k0+15 of a
// row-major tile are the depth, its columns n0..n0+15 the columns
// (ldmatrix .trans).  Same order as load_b_rows.
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const bf16* tile, int ld, int k0,
                                            int n0, int lane) {
  ldsm_x4_trans(b, tile + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld +
                       n0 + (lane / 16) * 8);
}

// Rows r0..r0+ROWS-1 (those below n_rows; the others zero) of a
// (rows, hd) matrix with row stride `stride` and unit column stride, into
// a shared tile of ROWS x ld bf16, all HD columns (zero past hd, so the
// products run over HD with no test of hd).  With `vec` (src 16-byte
// aligned, stride and hd multiples of 8) by 16-byte cp.async; otherwise
// element by element, synchronously.  The caller commits the group.
template <int ROWS, int HD, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long stride, int r0,
                                          int n_rows, int hd, bool vec,
                                          int tid) {
  constexpr int kChunks = HD / 8;          // 16-byte chunks of a full row
  constexpr int kRounds = ROWS * kChunks / THREADS;
  static_assert(ROWS * kChunks % THREADS == 0, "whole rounds of copies");
  if (vec) {
#pragma unroll
    for (int it = 0; it < kRounds; ++it) {
      const int e = tid + it * THREADS;
      const int r = e / kChunks, d = 8 * (e % kChunks);
      const bool ok = r0 + r < n_rows && d < hd;
      cp_async16(dst + r * ld + d, ok ? src + (r0 + r) * stride + d : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = tid; e < ROWS * kChunks; e += THREADS) {
      const int r = e / kChunks, d = 8 * (e % kChunks);
      __align__(16) bf16 x[8];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        x[t] = (r0 + r < n_rows && d + t < hd)
                   ? src[(r0 + r) * stride + d + t]
                   : __float2bfloat16_rn(0.0f);
      *reinterpret_cast<uint4*>(dst + r * ld + d) =
          *reinterpret_cast<const uint4*>(x);
    }
  }
}

// x / d rounded to nearest, given rd = 1 / d rounded to nearest
// (Markstein's correction step; the same result as IEEE division for
// quotients in the normal range, with no branch)
__device__ __forceinline__ float div_rn(float x, float d, float rd) {
  const float q = x * rd;
  return fmaf(fmaf(-q, d, x), rd, q);
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    f[2 * t] = __uint_as_float(w[t] << 16);
    f[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
  }
}

// The Euclidean norm of each row of a ROWS x HD shared tile that
// load_rows filled, into out[ROWS].  Each thread sums the squares of the
// 16-byte chunks it copied itself (visible to it once its own copies are
// waited for), and the HD / 8 threads that copied one row, lanes of one
// warp, add theirs with shuffles; so a kernel takes the norms of its next
// tile without another barrier, and publishes them with the barrier that
// publishes the tile.
template <int ROWS, int HD, int THREADS>
__device__ __forceinline__ void own_row_norms(float* out, const bf16* tile,
                                              int ld, int tid) {
  constexpr int kChunks = HD / 8;
  static_assert(kChunks <= 32 && THREADS % kChunks == 0, "a row a warp");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
    const int e = tid + it * THREADS;
    const int r = e / kChunks, c = e % kChunks;
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(tile + r * ld + 8 * c), f);
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 8; ++t) acc = fmaf(f[t], f[t], acc);
#pragma unroll
    for (int o = kChunks / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (c == 0) out[r] = sqrtf(acc);
  }
}

// The norms of a warp's rows r and r + 8 of a shared tile, each lane of a
// quad summing a quarter; every lane of the quad gets both.
__device__ __forceinline__ void quad_norms(const bf16* row, const bf16* row8,
                                           int hd, int lane, float& n0,
                                           float& n8) {
  n0 = n8 = 0.0f;
  for (int c = lane % 4; 8 * c < hd; c += 4) {
    float f[8], h[8];
    unpack8(*reinterpret_cast<const uint4*>(row + 8 * c), f);
    unpack8(*reinterpret_cast<const uint4*>(row8 + 8 * c), h);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      n0 = fmaf(f[t], f[t], n0);
      n8 = fmaf(h[t], h[t], n8);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    n0 += __shfl_xor_sync(0xffffffffu, n0, o);
    n8 += __shfl_xor_sync(0xffffffffu, n8, o);
  }
  n0 = sqrtf(n0);
  n8 = sqrtf(n8);
}

// Exact scores.  A plain float32 product (cuBLAS, and so the plain
// versions) sums q.k in order, d = 0, 1, ..., one fmaf a step: F.  The
// tensor cores' sum T is another float32 sum of the same products, so
// where F lies near a bf16 rounding midpoint T may round to the other
// neighbour (chip_smoke.py counts how often, and how far T strays from
// F, on 16.8 M random scores at hd 64 and 128).  Every sum within
// kSumTol x |q| |k| (Cauchy-Schwarz: >= 16 x 2^-24 sum_d |q_d k_d|, some
// three times the largest stray seen) of a midpoint, or so small that the
// tolerance reaches the next midpoint, is taken again in order, so every
// score rounds as F does.
constexpr float kSumTol = 16.0f / 16777216.0f;

__device__ __forceinline__ bool near_midpoint(float t, float tol) {
  const float mid =
      __uint_as_float((__float_as_uint(t) & 0xffff0000u) | 0x8000u);
  return fabsf(t - mid) <= tol || tol > fabsf(t) * (1.0f / 512.0f);
}

// sum_{d < n} a[d] b[d] in order, fmaf each step from 0: F above.  a and b
// shared rows, 16-byte aligned.
__device__ __forceinline__ float seq_dot(const bf16* a, const bf16* b,
                                         int n) {
  float acc = 0.0f;
  int d = 0;
  for (; d + 8 <= n; d += 8) {
    float x[8], y[8];
    unpack8(*reinterpret_cast<const uint4*>(a + d), x);
    unpack8(*reinterpret_cast<const uint4*>(b + d), y);
#pragma unroll
    for (int t = 0; t < 8; ++t) acc = fmaf(x[t], y[t], acc);
  }
  for (; d < n; ++d)
    acc = fmaf(__bfloat162float(a[d]), __bfloat162float(b[d]), acc);
  return acc;
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// A warp's scratch for fix_flagged, in shared memory.
template <int N>
struct FixScratch {
  int list[32];               // flagged entries: lane << 5 | entry
  uint32_t flips[32];         // by lane: entries whose rounding changed
  uint16_t slot[4 * N][32];   // by entry, then lane: bf16 of the sum
};

// Replace the entries of a warp's C fragments s (N 8-column blocks; entry
// e of block nb is bit 4 nb + e of `flags`) with their sequential sums,
// rounded to bf16 (all that is read of them).  Each owner leaves the
// rounding of its tensor-core sum in its entries' slots; the flagged
// entries are listed, each lane takes one (rows(lane, entry, a, b) gives
// its two shared rows), writes the rounding of the sequential sum over
// the slot and marks the owner's entry where the two differ; the owners
// read their slots back.  Returns the entries whose rounding changed.
// x.flips must start at 0 (it is left so).
template <int N, typename Rows>
__device__ __forceinline__ uint32_t fix_flagged(float (&s)[N][4],
                                                uint32_t flags,
                                                FixScratch<N>& x, int lane,
                                                int n, Rows rows) {
  static_assert(N <= 8, "32 entries a lane");
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((flags >> (4 * nb + e)) & 1u)
        x.slot[4 * nb + e][lane] = bf16_bits(s[nb][e]);
  const int cnt = __popc(flags);
  int off = cnt;                      // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, off, o);
    if (lane >= o) off += t;
  }
  const int total = __shfl_sync(0xffffffffu, off, 31);
  off -= cnt;
  for (int base = 0; base < total; base += 32) {
    int pos = off;
    for (uint32_t f = flags; f != 0; f &= f - 1, ++pos)
      if (pos >= base && pos < base + 32)
        x.list[pos - base] = (lane << 5) | (__ffs(f) - 1);
    __syncwarp();
    if (lane < total - base) {
      const int src = x.list[lane] >> 5, entry = x.list[lane] & 31;
      const bf16 *a, *b;
      rows(src, entry, a, b);
      const uint16_t f = bf16_bits(seq_dot(a, b, n));
      if (f != x.slot[entry][src]) atomicOr(&x.flips[src], 1u << entry);
      x.slot[entry][src] = f;
    }
    __syncwarp();
  }
#pragma unroll
  for (int nb = 0; nb < N; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if ((flags >> (4 * nb + e)) & 1u)
        s[nb][e] = __uint_as_float(
            static_cast<uint32_t>(x.slot[4 * nb + e][lane]) << 16);
  const uint32_t flips = x.flips[lane];
  x.flips[lane] = 0;
  return flips;
}

// A warp's log of the entries whose bf16 rounding fix_flagged changed, in
// the order of its tiles, so that a second sweep over the same tiles can
// set them again without testing and recomputing every sum.  kCap entries
// a warp; past that the log is `full` and the second sweep tests and
// recomputes as the first did.  n, full and the cursor are the same in
// every lane.
constexpr int kFlipCap = 64;

struct FlipLog {
  int* code;      // [kFlipCap]: tile << 10 | lane << 5 | entry
  float* val;     // [kFlipCap]: the sequential sum
  int n = 0;
  bool full = false;
};

// Log the entries `flips` of this lane that fix_flagged (scratch x, just
// returned) changed, with the values it left in their slots.
template <int N>
__device__ __forceinline__ void log_flips(FlipLog& lg, const FixScratch<N>& x,
                                          uint32_t flips, int tile,
                                          int lane) {
  const int cnt = __popc(flips);
  int off = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, off, o);
    if (lane >= o) off += t;
  }
  const int total = __shfl_sync(0xffffffffu, off, 31);
  int pos = lg.n + off - cnt;
  for (uint32_t f = flips; f != 0; f &= f - 1, ++pos) {
    const int e = __ffs(f) - 1;
    if (pos < kFlipCap) {
      lg.code[pos] = (tile << 10) | (lane << 5) | e;
      lg.val[pos] = __uint_as_float(static_cast<uint32_t>(x.slot[e][lane])
                                    << 16);
    }
  }
  lg.n += total;
  lg.full = lg.full || lg.n > kFlipCap;
  __syncwarp();
}

// Set the logged entries of `tile` (the log read from `cursor` on).
template <int N>
__device__ __forceinline__ void replay_flips(const FlipLog& lg,
                                             float (&s)[N][4], int& cursor,
                                             int tile, int lane) {
  const int n = min(lg.n, kFlipCap);
  for (; cursor < n && (lg.code[cursor] >> 10) == tile; ++cursor) {
    const int c = lg.code[cursor];
    if (((c >> 5) & 31) != lane) continue;
    const float f = lg.val[cursor];
#pragma unroll
    for (int nb = 0; nb < N; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((c & 31) == 4 * nb + e) s[nb][e] = f;
  }
}

__device__ __forceinline__ bool allowed(int kind, int window, int i, int j) {
  if (kind == kBidir) return true;
  bool m = j <= i;
  if (kind == kWindow && window > 0) m = m && (j > i - window);
  if (kind == kChunk && window > 0) m = m && (i / window == j / window);
  return m;
}

// Queries i_lo..i_hi against keys j_lo..j_hi (inclusive): kNone when no
// pair is admitted, kFull when every pair is (all inside Sq and Sk),
// kEdge when only the causal diagonal or the Sq / Sk tail refuses some,
// else kPartial.  Conservative: kPartial is always right.
__device__ __forceinline__ int tile_class(int kind, int window, int i_lo,
                                          int i_hi, int j_lo, int j_hi,
                                          int Sq, int Sk) {
  if (i_lo >= Sq || j_lo >= Sk) return kNone;
  const bool in = i_hi < Sq && j_hi < Sk;
  if (kind == kBidir) return in ? kFull : kEdge;
  if (j_lo > i_hi) return kNone;
  bool edge = true;                 // no window or chunk edge inside
  if (kind == kWindow && window > 0) {
    if (j_hi <= i_lo - window) return kNone;
    edge = j_lo > i_hi - window;
  }
  if (kind == kChunk && window > 0) {
    if (j_hi < (i_lo / window) * window) return kNone;
    edge = i_lo / window == i_hi / window && j_lo / window == i_lo / window &&
           j_hi / window == i_lo / window;
  }
  if (!edge) return kPartial;
  return in && j_hi <= i_lo ? kFull : kEdge;
}

// The entries (bit 4 nb + e) of a warp's C fragments that the mask
// refuses, where a window or chunk edge crosses the tile (kPartial: rare,
// so out of line).  Entry e of block nb is the pair (i0 + di, j0 + dj)
// with (di, dj) = (8 (e / 2), 8 nb + e % 2) when `rows_are_queries`,
// else (8 nb + e % 2, 8 (e / 2)).
template <int N>
__device__ __noinline__ uint32_t refused_bits(int kind, int window, int i0,
                                              int j0, int Sq, int Sk,
                                              bool rows_are_queries) {
  uint32_t bits = 0;
  for (int nb = 0; nb < N; ++nb)
    for (int e = 0; e < 4; ++e) {
      const int a = 8 * (e / 2), c = 8 * nb + e % 2;
      const int i = i0 + (rows_are_queries ? a : c);
      const int j = j0 + (rows_are_queries ? c : a);
      if (!(i < Sq && j < Sk && allowed(kind, window, i, j)))
        bits |= 1u << (4 * nb + e);
    }
  return bits;
}

// Set the entries of a warp's C fragments s (rows: queries i = wi + g +
// 8 (e / 2); columns: keys j = k0 + 8 nb + c2 + e % 2) that the mask
// refuses to `value`, for a tile of class kEdge or kPartial.
template <int N>
__device__ __forceinline__ void mask_rows(float (&s)[N][4], int cls, int kind,
                                          int window, int wi, int k0, int g,
                                          int c2, int Sq, int Sk,
                                          float value) {
  if (cls == kEdge) {
    // j - i = dji + 8 nb + e % 2 - 8 (e / 2): refused past the diagonal
    // (but for bidir) and past Sk or Sq
    const int dji = k0 + c2 - wi - g, jb = Sk - k0 - c2, ib = Sq - wi - g;
    const bool diag = kind != kBidir;
#pragma unroll
    for (int nb = 0; nb < N; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((diag && dji + 8 * nb + e % 2 - 8 * (e / 2) > 0) ||
            8 * nb + e % 2 >= jb || 8 * (e / 2) >= ib)
          s[nb][e] = value;
  } else if (cls == kPartial) {
    const uint32_t bits = refused_bits<N>(kind, window, wi + g, k0 + c2, Sq,
                                          Sk, true);
#pragma unroll
    for (int nb = 0; nb < N; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((bits >> (4 * nb + e)) & 1u) s[nb][e] = value;
  }
}

// The same with rows for keys j = wj + g + 8 (e / 2) and columns for
// queries i = i0 + 8 nb + c2 + e % 2 (the dk/dv pass's S^T).
template <int N>
__device__ __forceinline__ void mask_cols(float (&s)[N][4], int cls, int kind,
                                          int window, int wj, int i0, int g,
                                          int c2, int Sq, int Sk,
                                          float value) {
  if (cls == kEdge) {
    // j - i = dij + 8 (e / 2) - 8 nb - e % 2
    const int dij = wj + g - i0 - c2, ib = Sq - i0 - c2, jb = Sk - wj - g;
    const bool diag = kind != kBidir;
#pragma unroll
    for (int nb = 0; nb < N; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((diag && dij + 8 * (e / 2) - 8 * nb - e % 2 > 0) ||
            8 * nb + e % 2 >= ib || 8 * (e / 2) >= jb)
          s[nb][e] = value;
  } else if (cls == kPartial) {
    const uint32_t bits = refused_bits<N>(kind, window, i0 + c2, wj + g, Sq,
                                          Sk, false);
#pragma unroll
    for (int nb = 0; nb < N; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((bits >> (4 * nb + e)) & 1u) s[nb][e] = value;
  }
}

// 16-byte copies are possible: the pointer 16-byte aligned, the (batch,
// seq, head) strides and hd multiples of 8 elements
inline bool vec_ok(const void* p, long long sb, long long ss, long long sh,
                   int hd) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 8 == 0 &&
         ss % 8 == 0 && sh % 8 == 0 && hd % 8 == 0;
}

}  // namespace repro_tc
