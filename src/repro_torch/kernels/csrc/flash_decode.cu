// Flash decode: one new query token per sequence against a masked KV cache,
// for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (`flash_decode`, body `_decode_kernel`).  For batch row b and kv head
// kvh, whose G grouped query heads are h = kvh * G + g, it computes the
// model's decode attention (models/attention.py `decode_attend`) at the
// model's rounding points:
//   r_gj = q_g . k_j summed in float32, rounded to the input type
//   s_gj = r_gj / sqrt(hd), then softcap * tanh(s_gj / softcap) when
//          softcap > 0; only slots j with valid[b, j] take part
//   w_gj = exp(s_gj - m_g) / l_g in float32 (m_g, l_g the max and the sum
//          of exponentials over the valid slots), rounded to the input type
//   o_g  = sum_j w_gj v_j summed in float32, rounded to the input type;
//          0 when no slot is valid (the TPU kernel's guard).
// For float32 inputs the roundings do nothing.
//
// Bound on this card: bytes.  Every valid cache row is read once (k and v,
// 2 * hd elements per (b, kvh, slot)) for 4 * G * hd operations; at the
// serve path's step (B 16, K 8, W 529, hd 128, G 4, bf16) that is 34.7 MB,
// 0.0104 ms at 3.35 TB/s, against 0.2 GFLOP; at recurrentgemma-2b's step
// (B 16, K 1, W 529, hd 256, G 10) 8.7 MB, 0.0026 ms; at DECODE_32K (B 32,
// K 8, W 32,768, hd 128, G 4) 4.3 GB, 1.28 ms.
//
// Design.  The wrapper cuts the cache into n_split splits of at most 128
// consecutive slots (`ops.decode_split`: B * K * n_split reaches 264, two
// blocks an SM, where W allows), and two launches run one block of 4
// warps per (split, kvh, b), with no host synchronisation:
//   1. scores: the block copies its split's k rows (the valid ones; the
//      rest are zero-filled unread) into shared memory with 16-byte
//      cp.async, every row at once in groups of 32, and computes the scores
//      of all G query heads of its kv head as the groups land.  It writes
//      each valid slot's score s_gj (float32) to a scratch (B, H, W) and the
//      split's max and sum of exponentials per head to (B, H, n_split).
//   2. values: the block copies its split's v rows the same way and its
//      scores by 4-byte cp.async, meanwhile merges the n_split (max, sum)
//      pairs of each head (8 or 32 lanes a head, then a shuffle tree), forms
//      the rounded weights in shared memory, sums weights times v (a warp
//      a head group and a share of the rows) into a float32 partial per
//      (b, h, split), and the last block of each (b, kvh) to finish (an
//      atomic ticket, zeroed by launch 1 and again by that block) adds the
//      partials in split order and rounds.  Every sum runs in a fixed
//      order, so two calls give the same bits.
// What this does about the previous kernel's four limits (one block of 8
// warps per (b, kvh), reading k twice):
//   - too few blocks: it ran 128 blocks at the serve step and 48 at path
//     E's on 132 SMs; this one runs 640, 272 and 65,536 (DECODE_32K);
//   - too few bytes in flight: it kept a 4-row run per warp, 8 KB an SM,
//     in flight between shuffle trees; here every block requests its whole
//     split (16-32 KB at hd 128 bf16) before it uses the first row, and 5-6
//     blocks share an SM;
//   - k read twice: launch 2 reads the scores back instead (8 bytes a
//     score: 2.2 MB at the serve step against 17 MB of k);
//   - the same rows read once per head group: a block keeps all G heads,
//     looping over groups of GC heads (4 at hd 256) in shared memory.
// The weights are still rounded after dividing by the global sum, which
// is why there are two launches: a one-pass float32 kernel kept the card's
// model outside the bf16 tolerance of the host's plain path.
//
// Sum order: lane l of a warp owns head-dim elements [l * HD / 32,
// (l + 1) * HD / 32) of a row (HD the head dim padded to 64, 128 or 256,
// zeros past hd), sums its products by fmaf from 0 in order, and the 32
// lane sums meet in the xor tree 16, 8, 4, 2, 1: the order of the previous
// kernel, so every score is bit-equal to its.  The tree runs as a
// reduce-scatter (`warp_tree.cuh`): a run of R rows x GC heads (R * GC <=
// 32 sums) takes one shuffle a sum instead of five.  The divisions are
// Markstein steps on reciprocals rounded to nearest (IEEE results, no
// call).  The max and sum of exponentials are merged in another order than
// the previous kernel's, so a weight on a bf16 rounding edge may round the
// other way.
//
// ptxas (sm_90a, 128 threads a block; CUDA 12.8): scores 40-114 registers
// over the 24 instances (bf16 hd 128 with 4 heads a group: 73; hd 256:
// 96), values 102-111 (102; 110), no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "ieee_div.cuh"
#include "warp_tree.cuh"

namespace {

using repro_async::cp_async16;
using repro_async::cp_async4;
using repro_async::cp_async_commit;
using repro_async::cp_async_wait;
using repro_div::div_rn;
using repro_div::rcp_rn;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = 32;            // rows of one cp.async group
constexpr int kMaxRows = 128;            // rows of one split
constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;

constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// NW raw 32-bit words from p (device or shared), by 16-, 8- or 4-byte loads
template <int NW>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int c = 0; c < NW / 4; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      w[4 * c] = u.x; w[4 * c + 1] = u.y; w[4 * c + 2] = u.z;
      w[4 * c + 3] = u.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float get(const float* p, int i) { return p[i]; }
  __device__ static void words_to_f(const uint32_t* w, float* x, int nw) {
#pragma unroll
    for (int i = 0; i < nw; ++i) x[i] = __uint_as_float(w[i]);
  }
  __device__ static void put(float* p, float x) { *p = x; }
  __device__ static float round(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static float get(const __nv_bfloat16* p, int i) {
    return __bfloat162float(p[i]);
  }
  // little endian: element 2i is the low half of word i (exact widening)
  __device__ static void words_to_f(const uint32_t* w, float* x, int nw) {
#pragma unroll
    for (int i = 0; i < nw; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// this lane's EPL elements of a row; `vec` when the row is whole and
// aligned for word loads, else element by element with the hd guard
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* row, int lane, int hd,
                                         bool vec, float (&x)[EPL]) {
  constexpr int kNW = EPL / Elem<T>::kPerWord;
  if constexpr (kNW >= 1) {
    if (vec) {
      uint32_t w[kNW];
      load_words<kNW>(row + lane * EPL, w);
      Elem<T>::words_to_f(w, x, kNW);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane * EPL + e;
    x[e] = d < hd ? Elem<T>::get(row, d) : 0.0f;
  }
}

// Copy rows [s0, s0 + n) of one cache (row r at base + r * row_stride)
// into shared rows of HD elements: one cp.async group per 32 rows, 16
// bytes a copy where `vec` (then hd * sizeof(T) is a multiple of 16);
// invalid rows are zero-filled without being read, and so are the columns
// past hd.  Without `vec` the rows are copied element by element at once
// (the groups are then empty).  The caller waits with wait_tiles.
template <typename T, int HD>
__device__ __forceinline__ void copy_rows(T* s_rows, const T* base,
                                          long long row_stride,
                                          const uint8_t* ok, int s0, int n,
                                          int hd, bool vec) {
  const int tid = threadIdx.x;
  if (hd < HD) {
    for (int i = tid; i < n * (HD - hd); i += kThreads)
      s_rows[i / (HD - hd) * HD + hd + i % (HD - hd)] = T(0.0f);
  }
  if (!vec) {
    for (int i = tid; i < n * hd; i += kThreads) {
      const int r = i / hd, d = i % hd;
      s_rows[r * HD + d] = ok[s0 + r] ? base[(s0 + r) * row_stride + d]
                                      : T(0.0f);
    }
  }
  constexpr int kPer = 16 / sizeof(T);        // elements a copy
  const int cpr = vec ? hd / kPer : 0;        // copies a row
  for (int t0 = 0; t0 < n; t0 += kTileRows) {
    const int rows = min(kTileRows, n - t0);
    for (int i = tid; i < rows * cpr; i += kThreads) {
      const int r = t0 + i / cpr, c = i % cpr * kPer;
      const bool on = ok[s0 + r] != 0;
      const T* src = base + (on ? (s0 + r) * row_stride + c : 0);
      cp_async16(s_rows + r * HD + c, src, on ? 16 : 0);
    }
    cp_async_commit();
  }
}

// wait until this thread's copies of all but the last `pending` groups
// have landed
__device__ __forceinline__ void wait_tiles(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// (m, l) <- the max and sum of exponentials of the union of two sets
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <int HD, int GC>
struct Plan {
  static constexpr int kEPL = HD / 32;                 // elements a lane
  static constexpr int kR = GC >= 4 ? 32 / GC : 8;     // rows a run
  static constexpr int kN = kR * GC;                   // sums a run
  static constexpr int kShift = 5 - ilog2(kN);         // lane -> sum index
  static constexpr int kRowBit = 1 << (kShift + ilog2(GC));  // lane bit of u
};

// Launch 1: grid (n_split, K, B).  Scores of the split's valid slots to
// `scores` (B, H, W); per head, the split's max and sum of exponentials to
// `stats` (B, H, n_split).
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads)
decode_scores_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ scores, float2* __restrict__ stats,
                     int* __restrict__ tickets, int W, int K, int G,
                     int split_len, int hd, float sqrt_hd, float r_sqrt_hd,
                     float softcap, float r_softcap, int vec_ok) {
  using P = Plan<HD, GC>;
  constexpr int EPL = P::kEPL, R = P::kR, N = P::kN;
  extern __shared__ uint4 smem[];
  T* s_k = reinterpret_cast<T*>(smem);
  __shared__ float s_m[kWarps][GC], s_l[kWarps][GC];

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int s0 = split * split_len;
  const int n = min(split_len, W - s0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = K * G;
  const bool vec = vec_ok != 0;
  const uint8_t* ok = valid + (long long)b * W;
  if (split == 0 && threadIdx.x == 0) tickets[b * K + kvh] = 0;

  const long long row_stride = (long long)K * hd;
  copy_rows<T, HD>(s_k, kc + (long long)b * W * row_stride + (long long)kvh * hd,
                   row_stride, ok, s0, n, hd,
                   vec && (hd * (int)sizeof(T)) % 16 == 0);
  const int n_tiles = (n + kTileRows - 1) / kTileRows;

  // the sum this lane ends a run with: row u of the run, head gi of the
  // group; the lanes that share it (lead: the first of them)
  const int idx = lane >> P::kShift;
  const int u = idx / GC, gi = idx % GC;
  const bool lead = (lane & ((1 << P::kShift) - 1)) == 0;

  for (int g0 = 0; g0 < G; g0 += GC) {
    float qv[GC][EPL];
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qv[g][e] = 0.0f;
      if (g0 + g < G)
        load_row<T, EPL>(q + ((long long)b * H + kvh * G + g0 + g) * hd,
                         lane, hd, vec && hd == HD, qv[g]);
    }
    const int h = kvh * G + g0 + gi;
    const bool mine = lead && g0 + gi < G;
    float* srow = scores + ((long long)b * H + h) * W + s0;
    float m = kNegInf, l = 0.0f;
    for (int t = 0; t < n_tiles; ++t) {
      if (g0 == 0) {
        wait_tiles(n_tiles - 1 - t);
        __syncthreads();
      }
      for (int r0 = t * kTileRows + warp * R; r0 < min(n, (t + 1) * kTileRows);
           r0 += kWarps * R) {
        float p[N];
#pragma unroll
        for (int uu = 0; uu < R; ++uu) {
          float kx[EPL];
          load_row<T, EPL>(s_k + (r0 + uu) * HD, lane, HD, true, kx);
#pragma unroll
          for (int g = 0; g < GC; ++g) {
            float d = 0.0f;
#pragma unroll
            for (int e = 0; e < EPL; ++e) d = fmaf(qv[g][e], kx[e], d);
            p[uu * GC + g] = d;
          }
        }
        float x = repro_warp::tree_scatter<N, 16>(p, lane);
        const int r = r0 + u;
        if (mine && r < n && ok[s0 + r]) {
          x = div_rn(Elem<T>::round(x), sqrt_hd, r_sqrt_hd);
          if (softcap > 0.0f)
            x = softcap * tanhf(div_rn(x, softcap, r_softcap));
          srow[r] = x;
          const float mn = fmaxf(m, x);
          l = l * expf(m - mn) + expf(x - mn);
          m = mn;
        }
      }
    }
    // lanes of one head: over the row bits of the lane (the others hold
    // (kNegInf, 0)), then over the warps in order
#pragma unroll
    for (int o = 16; o >= P::kRowBit; o >>= 1)
      merge(m, l, __shfl_xor_sync(kFull, m, o), __shfl_xor_sync(kFull, l, o));
    if (lane == (gi << P::kShift) && u == 0) {
      s_m[warp][gi] = m;
      s_l[warp][gi] = l;
    }
    __syncthreads();
    if (threadIdx.x < GC && g0 + (int)threadIdx.x < G) {
      const int g = threadIdx.x;
      float mm = s_m[0][g], ll = s_l[0][g];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) merge(mm, ll, s_m[w][g], s_l[w][g]);
      stats[((long long)b * H + kvh * G + g0 + g) * n_split + split] =
          make_float2(mm, ll);
    }
    __syncthreads();
  }
}

// Launch 2: grid (n_split, K, B).  The split's rounded weights times v to
// `partial` (B, H, n_split, hd) float32; the last block of each (b, kvh)
// adds the partials in split order into o.
// (4 blocks an SM: without a count ptxas held this kernel near 72
// registers and spilled)
template <typename T, int HD, int GC>
__global__ void __launch_bounds__(kThreads, 4)
decode_values_kernel(const T* __restrict__ vc,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ scores,
                     const float2* __restrict__ stats,
                     float* __restrict__ partial, int* __restrict__ tickets,
                     T* __restrict__ o, int W, int K, int G, int split_len,
                     int hd, int vec_ok) {
  constexpr int EPL = HD / 32;
  extern __shared__ uint4 smem[];
  const int GP = (G + GC - 1) / GC * GC;      // heads padded to the group
  T* s_v = reinterpret_cast<T*>(smem);
  float* s_w = reinterpret_cast<float*>(s_v + split_len * HD);  // [j][GP]
  float* s_red = s_w + split_len * GP;        // [warp][GC][HD]
  float* s_M = s_red + kWarps * GC * HD;      // [GP]
  float* s_L = s_M + GP;                      // [GP]
  float* s_R = s_L + GP;                      // [GP], 1 / s_L
  __shared__ bool s_last;

  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int s0 = split * split_len;
  const int n = min(split_len, W - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int H = K * G;
  const uint8_t* ok = valid + (long long)b * W;
  const long long bh0 = (long long)b * H + kvh * G;   // row of head 0

  const long long row_stride = (long long)K * hd;
  copy_rows<T, HD>(s_v, vc + (long long)b * W * row_stride + (long long)kvh * hd,
                   row_stride, ok, s0, n, hd,
                   vec_ok != 0 && (hd * (int)sizeof(T)) % 16 == 0);

  // the block's scores, 4 bytes a copy, into s_w[j][g] (valid slots)
  for (int i = tid; i < G * n; i += kThreads) {
    const int g = i / n, j = i % n;
    if (ok[s0 + j])
      cp_async4(&s_w[j * GP + g], scores + (bh0 + g) * W + s0 + j);
  }
  cp_async_commit();
  // while they and the v rows come: the global max and sum of exponentials
  // of each head, lph lanes a head merging the splits in turn, then the
  // xor tree over those lanes
  const int lph = n_split > 64 ? 32 : 8;     // lanes a head
  for (int gr = 0; gr < G; gr += kWarps * (32 / lph)) {
    const int g = gr + warp * (32 / lph) + lane / lph, sub = lane % lph;
    float m = kNegInf, l = 0.0f;
    if (g < G) {
      const float2* st = stats + (bh0 + g) * n_split;
#pragma unroll 4
      for (int sp = sub; sp < n_split; sp += lph) {
        const float2 x = st[sp];
        merge(m, l, x.x, x.y);
      }
    }
    for (int off = lph / 2; off > 0; off >>= 1)
      merge(m, l, __shfl_xor_sync(kFull, m, off),
            __shfl_xor_sync(kFull, l, off));
    if (sub == 0 && g < G) {
      s_M[g] = m;
      s_L[g] = l;
      s_R[g] = l > 0.0f ? rcp_rn(l) : 0.0f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // the split's rounded weights, in place (0 at invalid slots and padded
  // heads)
  for (int i = tid; i < n * GP; i += kThreads) {
    const int j = i / GP, g = i % GP;
    float w = 0.0f;
    if (g < G && ok[s0 + j])
      w = Elem<T>::round(div_rn(expf(s_w[i] - s_M[g]), s_L[g], s_R[g]));
    s_w[i] = w;
  }
  __syncthreads();

  // weights times v.  Warp w takes head group w % n_hg and rows w / n_hg,
  // + rw, ... of the split, the rw warps of a group meeting in shared
  // memory; with more groups than warps, groups w, w + kWarps, ... and
  // every row.
  const int n_hg = GP / GC;
  const int rw = n_hg >= kWarps ? 1 : kWarps / n_hg;   // warps a group
  for (int hg0 = 0; hg0 < n_hg; hg0 += kWarps) {
    const int hg = rw == 1 ? hg0 + warp : warp % n_hg;
    const int rs = rw == 1 ? 0 : warp / n_hg;
    const int g0 = hg * GC;
    float acc[GC][EPL];
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] = 0.0f;
    if (hg < n_hg && rs < rw) {
      for (int j = rs; j < n; j += rw) {
        float vx[EPL], w[GC];
        load_row<T, EPL>(s_v + j * HD, lane, HD, true, vx);
        if constexpr (GC % 4 == 0) {   // GP and g0 are multiples of 4
#pragma unroll
          for (int c = 0; c < GC / 4; ++c) {
            const float4 f =
                reinterpret_cast<const float4*>(s_w + j * GP + g0)[c];
            w[4 * c] = f.x; w[4 * c + 1] = f.y; w[4 * c + 2] = f.z;
            w[4 * c + 3] = f.w;
          }
        } else {
#pragma unroll
          for (int g = 0; g < GC; ++g) w[g] = s_w[j * GP + g0 + g];
        }
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[g][e] = fmaf(w[g], vx[e], acc[g][e]);
      }
    }
    if (rw == 1) {             // the warp's sums are the group's
      if (hg < n_hg) {
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e) {
            const int d = lane * EPL + e;
            if (g0 + g < G && d < hd)
              partial[((bh0 + g0 + g) * n_split + split) * hd + d] =
                  acc[g][e];
          }
      }
    } else {                   // warps rs * n_hg + hg, rs < rw, in order
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          s_red[(warp * GC + g) * HD + lane * EPL + e] = acc[g][e];
      __syncthreads();
      for (int i = tid; i < n_hg * GC * hd; i += kThreads) {
        const int g = i / hd, d = i % hd;      // g over all padded heads
        if (g >= G) break;
        float a = 0.0f;
        for (int r = 0; r < rw; ++r)
          a += s_red[((r * n_hg + g / GC) * GC + g % GC) * HD + d];
        partial[((bh0 + g) * n_split + split) * hd + d] = a;
      }
    }
  }

  // the last block of (b, kvh) adds the partials in split order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(&tickets[b * K + kvh], 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // 8 outputs a thread at a time, the splits in order
  constexpr int kQ = 8;
  for (int i0 = tid; i0 < G * hd; i0 += kThreads * kQ) {
    const float* pp[kQ];
    float a[kQ];
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int i = min(i0 + q * kThreads, G * hd - 1);
      pp[q] = partial + (bh0 + i / hd) * n_split * hd + i % hd;
      a[q] = 0.0f;
    }
    int sp = 0;
    for (; sp + 4 <= n_split; sp += 4) {     // 4 x 8 loads in flight
      float x[4][kQ];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          x[u][q] = __ldcg(pp[q] + (long long)(sp + u) * hd);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < kQ; ++q) a[q] += x[u][q];
    }
    for (; sp < n_split; ++sp)
#pragma unroll
      for (int q = 0; q < kQ; ++q) a[q] += __ldcg(pp[q] + (long long)sp * hd);
    // a head with no valid slot has only zero weights: its sums are 0
#pragma unroll
    for (int q = 0; q < kQ; ++q)
      if (i0 + q * kThreads < G * hd)
        Elem<T>::put(o + bh0 * hd + i0 + q * kThreads, a[q]);
  }
  if (tid == 0) tickets[b * K + kvh] = 0;
}

// bytes of dynamic shared memory of launches 1 and 2
template <typename T, int HD, int GC>
void smem_bytes(int split_len, int G, size_t& b1, size_t& b2) {
  const size_t rows = (size_t)split_len * HD * sizeof(T);
  const size_t gp = (size_t)(G + GC - 1) / GC * GC;
  b1 = rows;
  b2 = rows + 4 * (split_len * gp + (size_t)kWarps * GC * HD + 3 * gp);
}

// raise a kernel's dynamic shared memory limit to `bytes` where needed (the
// default is 48 KB with the static shared memory)
template <typename F>
cudaError_t allow_smem(F kern, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

template <typename T, int HD, int GC>
int launch(const void* q, const void* kc, const void* vc, const void* valid,
           void* o, float* scores, float2* stats, float* partial,
           int* tickets, int B, int W, int K, int G, int hd, int n_split,
           int split_len, float softcap, int vec_ok, cudaStream_t stream) {
  size_t b1, b2;
  smem_bytes<T, HD, GC>(split_len, G, b1, b2);
  auto k1 = decode_scores_kernel<T, HD, GC>;
  auto k2 = decode_values_kernel<T, HD, GC>;
  static size_t allowed1 = 0, allowed2 = 0;   // per instantiation
  cudaError_t err = allow_smem(k1, b1, allowed1);
  if (err == cudaSuccess) err = allow_smem(k2, b2, allowed2);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, K, B);
  const float sqrt_hd = sqrtf((float)hd);
  const auto* v8 = static_cast<const uint8_t*>(valid);
  k1<<<grid, kThreads, b1, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), v8, scores, stats,
      tickets, W, K, G, split_len, hd, sqrt_hd, 1.0f / sqrt_hd, softcap,
      softcap > 0.0f ? 1.0f / softcap : 0.0f, vec_ok);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k2<<<grid, kThreads, b2, stream>>>(
      static_cast<const T*>(vc), v8, scores, stats, partial, tickets,
      static_cast<T*>(o), W, K, G, split_len, hd, vec_ok);
  return cudaGetLastError();
}

// GC, the heads a lane holds in registers: G rounded up to a power of two,
// at most 16 (hd <= 64), 8 (<= 128) or 4 (<= 256); the same rule as the
// wrapper's decode_split
template <typename T>
int dispatch(const void* q, const void* kc, const void* vc,
             const void* valid, void* o, float* scores, float2* stats,
             float* partial, int* tickets, int B, int W, int K, int G,
             int hd, int n_split, int split_len, float softcap, int vec_ok,
             cudaStream_t s) {
  const int HD = hd <= 64 ? 64 : hd <= 128 ? 128 : 256;
  int gc = 1;
  while (gc < G && gc < 1024 / HD) gc *= 2;
#define REPRO_FD_CASE(HDM, GCM)                                             \
  if (HD == HDM && gc == GCM)                                               \
    return launch<T, HDM, GCM>(q, kc, vc, valid, o, scores, stats, partial, \
                               tickets, B, W, K, G, hd, n_split, split_len, \
                               softcap, vec_ok, s);
  REPRO_FD_CASE(64, 1) REPRO_FD_CASE(64, 2) REPRO_FD_CASE(64, 4)
  REPRO_FD_CASE(64, 8) REPRO_FD_CASE(64, 16)
  REPRO_FD_CASE(128, 1) REPRO_FD_CASE(128, 2) REPRO_FD_CASE(128, 4)
  REPRO_FD_CASE(128, 8)
  REPRO_FD_CASE(256, 1) REPRO_FD_CASE(256, 2) REPRO_FD_CASE(256, 4)
#undef REPRO_FD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, 1, H, hd) and o contiguous; caches (B, W, K, hd) contiguous; valid
// (B, W) bytes (0 or 1).  dtype: 0 float32, 1 bfloat16.  vec_ok: every
// pointer is 16-byte aligned (the wrapper checks).  Scratch, from the
// wrapper: scores (B, H, W) float32, stats (B, H, n_split) float2, partial
// (B, H, n_split, hd) float32, tickets (B, K) int32 (any contents).  The
// splits: n_split of split_len slots (a multiple of 32, at most 128), the
// last one non-empty.  Two launches on `stream`, no synchronisation.
extern "C" int flash_decode_launch(const void* q, const void* kc,
                                   const void* vc, const void* valid, void* o,
                                   void* scores, void* stats, void* partial,
                                   void* tickets, int B, int W, int K, int H,
                                   int hd, int dtype, int n_split,
                                   int split_len, float softcap, int vec_ok,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || W < 1 || K < 1 || H < 1 || H % K != 0 || hd < 1 || hd > 256)
    return cudaErrorInvalidValue;
  if (split_len < 1 || split_len > kMaxRows || split_len % kTileRows != 0 ||
      n_split != (W + split_len - 1) / split_len || n_split > 65535)
    return cudaErrorInvalidValue;
  const int G = H / K;
  auto* sc = static_cast<float*>(scores);
  auto* st = static_cast<float2*>(stats);
  auto* pa = static_cast<float*>(partial);
  auto* tk = static_cast<int*>(tickets);
  if (dtype == 0)
    return dispatch<float>(q, kc, vc, valid, o, sc, st, pa, tk, B, W, K, G,
                           hd, n_split, split_len, softcap, vec_ok, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, kc, vc, valid, o, sc, st, pa, tk, B, W,
                                   K, G, hd, n_split, split_len, softcap,
                                   vec_ok, s);
  return cudaErrorInvalidValue;
}
