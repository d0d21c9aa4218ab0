// Flash attention forward (score tile never in device memory), for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention`, bodies `_flash_kernel` and `_mask_tile`).  For query
// head h of batch row b, with kv head h / G (GQA), it computes the model's
// attention (the reference package's models/attention.py `_attend_dense`)
// at the model's rounding points:
//   r_ij = q_i . k_j summed in float32, rounded to the input type
//   s_ij = r_ij / sqrt(hd), then softcap * tanh(s_ij / softcap) when
//          softcap > 0; refused (i, j) take no part.  (With a softcap the
//          model adds its -2e30 mask before the tanh, so a refused key
//          scores -softcap and keeps a small weight, and a row with no key
//          averages v; as the TPU kernel does, this kernel masks after
//          the tanh, and refused keys get no weight.)
//   w_ij = exp(s_ij - max_j s_ij) / sum_j exp(s_ij - max_j s_ij), rounded
//          to the input type
//   o_i  = sum_j w_ij v_j summed in float32, rounded to the input type;
//          0 for a row with no key (the TPU kernel's guard).
// For float32 inputs the roundings do nothing.  Mask kinds, in absolute
// positions i (query) and j (key), j < Sk always: causal j <= i; window
// j <= i and j > i - window; chunk j <= i and i / window == j / window;
// bidir and cross every j.  When asked (the training forward), it also
// writes each row's max m_i of the scores it admits and its sum of
// exponentials l_i = sum_j exp(s_ij - m_i), float32 (B, H, Sq), which the
// backward (flash_attention_bwd.cu) reads to recompute the weights; pass
// 1 has both already, so this costs one store per row.
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): at
// qwen3-8b's serve prefill (B 16, H 32, K 8, S 512, hd 128, causal) the
// kernel must read q, k, v and write o, about 168 MB (0.050 ms), and do
// about 34 GFLOP of products on the causal half (0.035 ms); at
// recurrentgemma-2b's (B 16, S 512, H 10, K 1, hd 256, window 2,048, so
// causal at S 512) about 92 MB (0.028 ms) and 21.5 GFLOP (0.022 ms).
// Both are bytes-bound by a small margin.  This kernel is far from
// either: PERF.md has its times (chip_smoke.py) and what holds it back.
//
// Two passes over the keys.  The TPU kernel (online softmax, one pass)
// never rounds the weights; rounding them as the model does needs each
// row's max and sum before any weight, so pass 1 takes the row's running
// max and sum of exponentials from the scores, and pass 2 recomputes the
// scores and accumulates the rounded weights times v.  That is three
// products of the score shape per key tile against a one-pass kernel's
// two; a one-pass float32-weight kernel was refused because it put the
// card's 2-layer qwen3-8b 0.055 in the logits from the host's plain path.
//
// bf16 (every path that serves or trains): the tensor cores
// (tensor_core.cuh).  A block of 4 warps owns 64 query rows of one
// (b, h), 16 rows a warp; every product is mma.sync m16n8k16 (bf16 in,
// float32 sums) on fragments that ldmatrix reads from shared memory.  q
// is copied once; up to hd 128 each warp then holds its 16 rows as A
// fragments, at hd 256 (whose 128 output accumulators a thread leave no
// room) ldmatrix reads them again at each 16-deep step.  k (pass 1) and
// k, v (pass 2) come in tiles of 64 keys (32 at hd 256), double-buffered
// by 16-byte cp.async: tile u + 1 is issued right after the one barrier
// of tile u (which also ends tile u - 1, so its stage is free) and lands
// while tile u's products run.  Tile rows are padded by 16 bytes, so the
// 8 rows an ldmatrix phase reads fall on distinct banks.  S = q k^T lands
// in float32 accumulators; rounding r to bf16, the division by sqrt(hd)
// (a Markstein step on the rounded reciprocal: IEEE division, no branch),
// the softcap and the mask all happen in registers, and a row's max and
// sum are reduced over the 4 lanes that hold it.  Pass 2 rounds each
// weight to bf16 and packs it straight from the C fragments into the A
// fragments of P . V (two adjacent 8-key C tiles are one 16-key A tile):
// the model rounds the weights to bf16 anyway, so the packing is exact
// and the weights never touch shared memory.
//
// Exact sums.  The plain version's float32 product (cuBLAS) sums each
// score in order, one fmaf a step; the tensor cores sum in another order,
// so a few scores in 10^5 would round to the neighbouring bf16 value
// (chip_smoke.py counts them), each moving l by up to its step over
// sqrt(hd), some 2% for a row's largest score at hd 128, where the row
// statistics must match the plain ones to float32 rounding and the
// backward's recomputed weights must be the forward's.  So pass 1 takes
// every sum that lies within 16 x 2^-24 |q_i| |k_j| of a bf16 rounding
// midpoint (a few in 100) again in order (tensor_core.cuh
// fix_flagged: a warp's flagged sums are listed and each lane takes one),
// and logs, per warp, the few whose rounding that changes; pass 2 sets
// the logged ones instead of testing again (or, past kFlipCap of them,
// tests and recomputes as pass 1 did).  Every score then rounds as the
// plain version's, and the backward, which does the same, rebuilds the
// forward's softmax bit for bit.  The key norms come from each thread's
// own copies of the tile (no second read, no second barrier), the query
// norms from the warp's own rows.
//
// Each warp classifies each key tile against its 16 rows: tiles no row
// can see are skipped, tiles every row sees whole take no mask, tiles
// that only the causal diagonal or the Sq / Sk tail crosses take a cheap
// offset test, and only tiles a window or chunk edge crosses call the
// general test (out of line).  Blocks start in reverse order, so the
// causal blocks with the most keys go first.  Loads use 16-byte copies
// when q, k, v start 16-byte aligned and their strides and hd are
// multiples of 8 elements; otherwise the same kernel loads element by
// element.  Rows past Sq, keys past Sk and columns past hd are zero-filled
// and the products run over the instance's whole head dim, so any Sq, Sk
// and hd <= 256 work; o leaves through the warp's rows of shared memory
// in 16-byte stores.
//
// float32 (the whole-model float32 checks only; no path runs attention in
// float32): the first version, float32 FMAs from float32 tiles in shared
// memory, unchanged: a block of 256 threads owns 64 query rows up to hd
// 128, 32 at hd 256; four threads share a row (eight at hd 256), each
// holding 8 (4) of a 32-key tile's scores and a quarter (an eighth) of
// the row's output (at most 32 floats) in registers; the weights go
// through shared memory (s_p).  It never uses the tensor cores (the
// port's float32 products stay IEEE float32).
//
// Inputs are read through their strides in the model's (B, S, heads, hd)
// layout; no transposed copy is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kBK = 32;        // keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -0.7f * FLT_MAX;

// threads that share a query row: 4 up to hd 128, 8 at hd 256, so that a
// thread holds hd / kPerRow = 32 output accumulators at every head dim
// (64 at hd 256 with 4 per row would leave too few registers for 256
// threads).  A block of 256 threads owns kThreads / kPerRow query rows.
template <int HD>
struct Tile {
  static constexpr int kPerRow = HD > 128 ? 8 : 4;
  static constexpr int kBQ = kThreads / kPerRow;   // query rows per block
  static constexpr int kCols = kBK / kPerRow;      // scores per thread
  static constexpr size_t smem_bytes() {
    return sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD +
                            kBQ * (kBK + 1));
  }
};

// the mask kinds and their test, shared with the bf16 instances
using repro_tc::allowed;
using repro_tc::kBidir;
using repro_tc::kChunk;
using repro_tc::kWindow;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
// x rounded to T, back in float32 (these templates are instantiated for
// float32 only; bf16 runs the tensor-core kernel below)
__device__ __forceinline__ float round_to(float x, float) { return x; }

struct Strides {
  long long b, s, h;   // elements; the head dim has stride 1
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       float* __restrict__ m_out, float* __restrict__ l_out,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       int Sq, int Sk, int hd, int G, int kind, int window,
                       float sqrt_hd, float softcap) {
  constexpr int kPerRow = Tile<HD>::kPerRow;
  constexpr int kBQ = Tile<HD>::kBQ;
  constexpr int kCols = Tile<HD>::kCols;
  constexpr int LD = HD + 1;            // padded row, in floats
  constexpr int kAcc = HD / kPerRow;    // output columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;                    // [kBQ][LD]
  float* s_k = s_q + kBQ * LD;          // [kBK][LD]
  float* s_v = s_k + kBK * LD;          // [kBK][HD]
  float* s_p = s_v + kBK * HD;          // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const int r = tid / kPerRow;          // this thread's query row
  const int part = tid % kPerRow;       // its part of the row
  const int i = q0 + r;                 // absolute query position

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int rr = e / HD, d = e % HD;
    const int qi = q0 + rr;
    s_q[rr * LD + d] =
        (qi < Sq && d < hd) ? to_f(qb[qi * sq.s + d]) : 0.0f;
  }

  // the key range this block's rows can see (all of it for bidir)
  const int i_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;              // [k_lo, k_hi)
  if (kind != kBidir) {
    k_hi = min(Sk, i_last + 1);
    if (kind == kWindow && window > 0) k_lo = max(0, q0 - window + 1);
    if (kind == kChunk && window > 0) k_lo = (q0 / window) * window;
  }
  k_lo = (k_lo / kBK) * kBK;

  // the row's scores of one tile: this thread's kCols of them, refused
  // ones at kNegInf
  auto tile_scores = [&](int k0, float (&s)[kCols]) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = 0.0f;
    const float* qrow = s_q + r * LD;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        s[c] = fmaf(qd, s_k[(part + kPerRow * c) * LD + d], s[c]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int kj = k0 + part + kPerRow * c;
      float x = round_to(s[c], T()) / sqrt_hd;
      if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
      s[c] = (i < Sq && kj < Sk && allowed(kind, window, i, kj)) ? x
                                                                 : kNegInf;
    }
  };
  auto load_tile = [&](int k0, bool with_v) {
    __syncthreads();   // the previous tile's k, v and w are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int kj = k0 + c;
      const bool in = kj < Sk && d < hd;
      s_k[c * LD + d] = in ? to_f(kb[kj * sk.s + d]) : 0.0f;
      if (with_v) s_v[c * HD + d] = in ? to_f(vb[kj * sv.s + d]) : 0.0f;
    }
    __syncthreads();
  };

  // pass 1: the row's max and sum of exp(s - max), online over the tiles
  float m_run = kNegInf, l_run = 0.0f;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    load_tile(k0, false);
    float s[kCols];
    tile_scores(k0, s);
    float m_tile = kNegInf;
#pragma unroll
    for (int c = 0; c < kCols; ++c) m_tile = fmaxf(m_tile, s[c]);
#pragma unroll
    for (int x = 1; x < kPerRow; x <<= 1)
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, x));
    const float m_new = fmaxf(m_run, m_tile);
    // a row with no key seen yet adds nothing (exp(NEG_INF - NEG_INF) is 1)
    const bool any = m_new > kNegInf * 0.5f;
    float l_tile = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) l_tile += any ? expf(s[c] - m_new) : 0.0f;
#pragma unroll
    for (int x = 1; x < kPerRow; x <<= 1)
      l_tile += __shfl_xor_sync(0xffffffffu, l_tile, x);
    if (any) l_run = l_run * expf(m_run - m_new) + l_tile;
    m_run = m_new;
  }

  // pass 2: the rounded weights times v
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.0f;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    load_tile(k0, true);
    float s[kCols];
    tile_scores(k0, s);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float w = l_run > 0.0f
          ? round_to(expf(s[c] - m_run) / l_run, T()) : 0.0f;
      s_p[r * (kBK + 1) + part + kPerRow * c] = w;
    }
    __syncwarp();      // the row's w, written by its lanes of one warp
    const float* prow = s_p + r * (kBK + 1);
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float w = prow[c];
      const float* vrow = s_v + c * HD + part;
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
        acc[a] = fmaf(w, vrow[kPerRow * a], acc[a]);
    }
  }

  if (i < Sq) {
    if (m_out != nullptr && part == 0) {
      const long long row = (static_cast<long long>(b) * gridDim.y + h) * Sq
                            + i;
      m_out[row] = m_run;
      l_out[row] = l_run;
    }
    T* orow = o + b * so.b + i * so.s + h * so.h;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int d = part + kPerRow * a;
      if (d < hd) from_f(orow + d, acc[a]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           float* m_out, float* l_out, Strides sq, Strides sk, Strides sv,
           Strides so, int B, int H, int Sq, int Sk, int hd, int G, int kind,
           int window,
           float softcap, cudaStream_t stream) {
  const size_t bytes = Tile<HD>::smem_bytes();
  constexpr int kBQ = Tile<HD>::kBQ;
  auto kern = flash_attention_kernel<T, HD>;
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m_out, l_out, sq, sk,
      sv, so, Sq, Sk, hd, G, kind, window, sqrtf((float)hd), softcap);
  return cudaGetLastError();
}

// ---- bf16: the tensor cores ---------------------------------------------

namespace tc = repro_tc;

template <int HD>
struct Bf16Tile {
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;          // query rows per block
  static constexpr int kBK = HD > 128 ? 32 : 64;   // keys per tile
  static constexpr int kLD = HD + 8;               // padded row, elements
  static constexpr bool kQRegs = HD <= 128;        // q held as fragments
  static constexpr size_t smem_bytes() {
    return sizeof(__nv_bfloat16) * (kBQ + 4 * kBK) * kLD   // q, 2 k, 2 v
           + sizeof(float) * (2 * kBK + 4)                 // key norms
           + (sizeof(tc::FixScratch<kBK / 8>) +            // exact sums
              (sizeof(int) + sizeof(float)) * tc::kFlipCap) * kWarps;
  }
};

struct Bf16Args {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float *m_out, *l_out;
  Strides sq, sk, sv, so;
  int Sq, Sk, hd, G, kind, window;
  float sqrt_hd, r_sqrt_hd, softcap, r_softcap;
  bool vec, vec_o;     // 16-byte copies of q, k, v; of o
};

template <int HD>
__global__ void __launch_bounds__(Bf16Tile<HD>::kThreads)
flash_attention_bf16_kernel(Bf16Args a) {
  using Cfg = Bf16Tile<HD>;
  using tc::bf16;
  constexpr int kBQ = Cfg::kBQ, kBK = Cfg::kBK, LD = Cfg::kLD;
  constexpr int kT = Cfg::kThreads;
  constexpr int kNB = kBK / 8;     // 8-key blocks of a tile
  constexpr int kKS = HD / 16;     // 16-deep steps over the head dim
  constexpr int kND = HD / 8;      // 8-column blocks of the output
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_tc);   // [kBQ][LD]
  bf16* s_k = s_q + kBQ * LD;                     // [2][kBK][LD]
  bf16* s_v = s_k + 2 * kBK * LD;                 // [2][kBK][LD]
  float* s_kn = reinterpret_cast<float*>(s_v + 2 * kBK * LD);  // [2][kBK]
  int* s_full = reinterpret_cast<int*>(s_kn + 2 * kBK);   // a log is full
  auto* s_fix = reinterpret_cast<tc::FixScratch<kNB>*>(s_full + 4);
  int* s_flip = reinterpret_cast<int*>(s_fix + Cfg::kWarps);
                                  // [warps][kFlipCap] codes, then values

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int r0 = 16 * warp;          // the warp's first row in the block
  const int wi = q0 + r0;            // ... in the sequence
  const int hd = a.hd, Sq = a.Sq, Sk = a.Sk;
  tc::FlipLog flog;                  // pass 1's changed roundings
  flog.code = s_flip + tc::kFlipCap * warp;
  flog.val = reinterpret_cast<float*>(s_flip + tc::kFlipCap * Cfg::kWarps) +
             tc::kFlipCap * warp;
  int cursor = 0;                    // pass 2's place in the log
  tc::FixScratch<kNB>& fix = s_fix[warp];
  fix.flips[lane] = 0;
  const bf16* qb = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* kb = a.k + b * a.sk.b + kvh * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + kvh * a.sv.h;

  // the key range this block's rows can see (all of it for bidir)
  const int i_last = min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;           // [k_lo, k_hi)
  if (a.kind != tc::kBidir) {
    k_hi = min(Sk, i_last + 1);
    if (a.kind == tc::kWindow && a.window > 0)
      k_lo = max(0, q0 - a.window + 1);
    if (a.kind == tc::kChunk && a.window > 0)
      k_lo = (q0 / a.window) * a.window;
  }
  k_lo = (k_lo / kBK) * kBK;
  const int n = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  // tile u < n: pass 1 over keys k_lo + u kBK (k only); n <= u < 2n: pass
  // 2 over the same keys (k and v); stage u % 2.  Tile u + 1 is issued
  // after the barrier that ends tile u - 1, into the stage it used; at
  // the end of tile u each thread waits for its copies of tile u + 1 and
  // takes their part of its key norms (for the exact sums), which the
  // next barrier publishes with the tile.  Pass 2 needs them only where a
  // warp's log overflowed (s_full).
  auto key0 = [&](int u) { return k_lo + (u < n ? u : u - n) * kBK; };
  auto issue = [&](int u) {
    if (u < 2 * n) {
      const int st = (u % 2) * kBK * LD;
      tc::load_rows<kBK, HD, kT>(s_k + st, LD, kb, a.sk.s, key0(u), Sk, hd,
                                 a.vec, tid);
      if (u >= n)
        tc::load_rows<kBK, HD, kT>(s_v + st, LD, vb, a.sv.s, key0(u), Sk,
                                   hd, a.vec, tid);
    }
    tc::cp_async_commit();
  };
  tc::load_rows<kBQ, HD, kT>(s_q, LD, qb, a.sq.s, q0, Sq, hd, a.vec, tid);
  issue(0);
  tc::cp_async_wait<0>();
  if (n > 0) tc::own_row_norms<kBK, HD, kT>(s_kn, s_k, LD, tid);
  if (tid == 0) *s_full = 0;

  uint32_t qf[Cfg::kQRegs ? kKS : 1][4];
  float qn[2];                           // |q| of rows g, g + 8, scaled
  float m_run[2] = {kNegInf, kNegInf};   // rows g and g + 8 of the warp
  float l_run[2] = {0.0f, 0.0f};         // this lane's part until pass 2
  float rl[2] = {0.0f, 0.0f};            // 1 / l, 0 for a row with no key
  float acc[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;

  for (int u = 0; u < 2 * n; ++u) {
    tc::cp_async_wait<0>();
    __syncthreads();                 // tile u in shared memory; u - 1 done
    issue(u + 1);
    const bool norms_next = u + 1 < 2 * n && (u + 1 <= n || *s_full);
    const bf16* t_k = s_k + (u % 2) * kBK * LD;
    const bf16* t_v = s_v + (u % 2) * kBK * LD;
    const float* t_kn = s_kn + (u % 2) * kBK;
    if (u == 0) {
      tc::quad_norms(s_q + (r0 + g) * LD, s_q + (r0 + g + 8) * LD, hd, lane,
                     qn[0], qn[1]);
      qn[0] *= tc::kSumTol;
      qn[1] *= tc::kSumTol;
      if constexpr (Cfg::kQRegs) {
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk)
          tc::load_a(qf[kk], s_q, LD, r0, 16 * kk, lane);
      }
    }
    if (u == n) {                    // pass 1 done: the row's whole sum
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        rl[r] = l_run[r] > 0.0f ? 1.0f / l_run[r] : 0.0f;
      }
    }
    const bool pass2 = u >= n;
    const int k0 = k_lo + (pass2 ? u - n : u) * kBK;
    const int cls = tc::tile_class(a.kind, a.window, wi, wi + 15, k0,
                                   k0 + kBK - 1, Sq, Sk);
    if (cls != tc::kNone) {
      // S = q k^T over the tile, in float32 accumulators
      float s[kNB][4];
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t af[4];
        if constexpr (Cfg::kQRegs) {
#pragma unroll
          for (int t = 0; t < 4; ++t) af[t] = qf[kk][t];
        } else {
          tc::load_a(af, s_q, LD, r0, 16 * kk, lane);
        }
#pragma unroll
        for (int nb = 0; nb < kNB; nb += 2) {
          uint32_t bb[4];
          tc::load_b_rows(bb, t_k, LD, 8 * nb, 16 * kk, lane);
          tc::mma(s[nb], af, bb[0], bb[1]);
          tc::mma(s[nb + 1], af, bb[2], bb[3]);
        }
      }
      // pass 1 takes the sums near a bf16 rounding midpoint again in
      // order and logs those whose rounding changes; pass 2 sets the
      // logged ones (element e of block nb is row g + 8 (e / 2), key
      // 8 nb + c2 + e % 2)
      if (!pass2 || flog.full) {
        uint32_t flags = 0;
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
          const float2 kn = *reinterpret_cast<const float2*>(t_kn + 8 * nb +
                                                             c2);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (tc::near_midpoint(s[nb][e],
                                  qn[e / 2] * (e % 2 ? kn.y : kn.x)))
              flags |= 1u << (4 * nb + e);
        }
        uint32_t flips = 0;
        if (__any_sync(0xffffffffu, flags != 0))
          flips = tc::fix_flagged(
              s, flags, fix, lane, hd,
              [&](int src, int code, const bf16*& x, const bf16*& y) {
                x = s_q + (r0 + src / 4 + 8 * (code % 4 / 2)) * LD;
                y = t_k + (8 * (code / 4) + 2 * (src % 4) + code % 2) * LD;
              });
        if (!pass2 && __any_sync(0xffffffffu, flips != 0)) {
          tc::log_flips(flog, fix, flips, u, lane);
          if (flog.full && lane == 0) *s_full = 1;
        }
      } else {
        tc::replay_flips(flog, s, cursor, u - n, lane);
      }
      // the scores: rounded to bf16, over sqrt(hd), capped, masked
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nb][e] = tc::div_rn(tc::round_bf16(s[nb][e]), a.sqrt_hd,
                                a.r_sqrt_hd);
      if (a.softcap > 0.0f) {
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nb][e] = a.softcap * tanhf(tc::div_rn(s[nb][e], a.softcap,
                                                    a.r_softcap));
      }
      tc::mask_rows(s, cls, a.kind, a.window, wi, k0, g, c2, Sq, Sk,
                    kNegInf);
      if (!pass2) {
        // pass 1: the row's running max (over its 4 lanes) and this
        // lane's part of the sum of exp(s - max)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mt = kNegInf;
#pragma unroll
          for (int nb = 0; nb < kNB; ++nb)
            mt = fmaxf(mt, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
          const float m_new = fmaxf(m_run[r], mt);
          // a row with no key seen yet adds nothing
          if (m_new > kNegInf * 0.5f) {
            float lt = 0.0f;
#pragma unroll
            for (int nb = 0; nb < kNB; ++nb)
              lt += expf(s[nb][2 * r] - m_new) +
                    expf(s[nb][2 * r + 1] - m_new);
            l_run[r] = l_run[r] * expf(m_run[r] - m_new) + lt;
          }
          m_run[r] = m_new;
        }
      } else {
        // pass 2: the weights exp(s - m) / l, rounded to bf16 as they are
        // packed from the C fragments into A fragments, times v
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2;
            s[nb][e] = tc::div_rn(expf(s[nb][e] - m_run[r]), l_run[r],
                                  rl[r]);
          }
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint32_t p[4] = {
              tc::pack(s[2 * kk][0], s[2 * kk][1]),
              tc::pack(s[2 * kk][2], s[2 * kk][3]),
              tc::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
              tc::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
          for (int nd = 0; nd < kND; nd += 2) {
            uint32_t bb[4];
            tc::load_b_cols(bb, t_v, LD, 16 * kk, 8 * nd, lane);
            tc::mma(acc[nd], p, bb[0], bb[1]);
            tc::mma(acc[nd + 1], p, bb[2], bb[3]);
          }
        }
      }
    }
    if (norms_next) {
      tc::cp_async_wait<0>();        // this thread's copies of tile u + 1
      tc::own_row_norms<kBK, HD, kT>(s_kn + ((u + 1) % 2) * kBK,
                                     s_k + ((u + 1) % 2) * kBK * LD, LD, tid);
    }
  }
  tc::cp_async_wait<0>();
  __syncthreads();                   // (q's copies, when there is no tile)

  // the row statistics, and o through the warp's own rows of s_q, so that
  // o leaves in 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wi + g + 8 * r;
    if (a.m_out != nullptr && c2 == 0 && i < Sq) {
      const long long row = (static_cast<long long>(b) * gridDim.y + h) * Sq
                            + i;
      a.m_out[row] = m_run[r];
      a.l_out[row] = l_run[r];
    }
    bf16* srow = s_q + (r0 + g + 8 * r) * LD;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
      *reinterpret_cast<uint32_t*>(srow + 8 * nd + c2) =
          tc::pack(acc[nd][2 * r], acc[nd][2 * r + 1]);
  }
  __syncwarp();
  const int rows = min(16, Sq - wi);
  if (a.vec_o) {
    for (int e = lane; e < 16 * kND; e += 32) {
      const int rr = e / kND, c = e % kND;
      if (rr < rows && 8 * c < hd)
        *reinterpret_cast<uint4*>(a.o + b * a.so.b + (wi + rr) * a.so.s +
                                  h * a.so.h + 8 * c) =
            *reinterpret_cast<const uint4*>(s_q + (r0 + rr) * LD + 8 * c);
    }
  } else {
    for (int e = lane; e < 16 * HD; e += 32) {
      const int rr = e / HD, d = e % HD;
      if (rr < rows && d < hd)
        a.o[b * a.so.b + (wi + rr) * a.so.s + h * a.so.h + d] =
            s_q[(r0 + rr) * LD + d];
    }
  }
}

template <int HD>
int launch_bf16(const Bf16Args& a, int B, int H, cudaStream_t stream) {
  using Cfg = Bf16Tile<HD>;
  const size_t bytes = Cfg::smem_bytes();
  auto kern = flash_attention_bf16_kernel<HD>;
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dim3 grid((a.Sq + Cfg::kBQ - 1) / Cfg::kBQ, H, B);
  kern<<<grid, Cfg::kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---- the exact sums, observed ------------------------------------------
//
// Not on any path: q (S, hd) . k (S, hd)^T for one head, through the
// forward's tensor-core sums and exact-sum fallback (tensor_core.cuh), so
// that a test can hold them against a plain float32 product.  Writes
// three (S, S) float32 matrices: t, the tensor-core sums; fixed, the same
// with the flagged sums replaced by the bf16 rounding of their sequential
// sums (what the forward rounds to bf16); seq, every sum taken
// sequentially (fmaf from d = 0), as a plain float32 product takes it.

template <int HD>
__global__ void __launch_bounds__(128)
score_sums_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k, float* t,
                  float* fixed, float* seq, int S, int hd) {
  using tc::bf16;
  constexpr int LD = HD + 8, kBK = 64, kNB = kBK / 8, kKS = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_tc);       // [64][LD]
  bf16* s_k = s_q + 64 * LD;                          // [kBK][LD]
  float* s_kn = reinterpret_cast<float*>(s_k + kBK * LD);   // [kBK]
  auto* s_fix = reinterpret_cast<tc::FixScratch<kNB>*>(s_kn + kBK);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c2 = 2 * (lane % 4), r0 = 16 * warp;
  const int q0 = blockIdx.x * 64;
  tc::FixScratch<kNB>& fix = s_fix[warp];
  fix.flips[lane] = 0;
  tc::load_rows<64, HD, 128>(s_q, LD, q, hd, q0, S, hd, true, tid);
  float qn[2];
  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();                  // the previous tile is consumed
    tc::load_rows<kBK, HD, 128>(s_k, LD, k, hd, k0, S, hd, true, tid);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    tc::own_row_norms<kBK, HD, 128>(s_kn, s_k, LD, tid);
    __syncthreads();
    if (k0 == 0) {
      tc::quad_norms(s_q + (r0 + g) * LD, s_q + (r0 + g + 8) * LD, hd, lane,
                     qn[0], qn[1]);
      qn[0] *= tc::kSumTol;
      qn[1] *= tc::kSumTol;
    }
    float s[kNB][4] = {};
    for (int kk = 0; kk < kKS; ++kk) {
      uint32_t af[4];
      tc::load_a(af, s_q, LD, r0, 16 * kk, lane);
      for (int nb = 0; nb < kNB; nb += 2) {
        uint32_t bb[4];
        tc::load_b_rows(bb, s_k, LD, 8 * nb, 16 * kk, lane);
        tc::mma(s[nb], af, bb[0], bb[1]);
        tc::mma(s[nb + 1], af, bb[2], bb[3]);
      }
    }
    auto at = [&](int nb, int e) {
      return static_cast<long long>(q0 + r0 + g + 8 * (e / 2)) * S + k0 +
             8 * nb + c2 + e % 2;
    };
    auto inside = [&](int nb, int e) {
      return q0 + r0 + g + 8 * (e / 2) < S && k0 + 8 * nb + c2 + e % 2 < S;
    };
    uint32_t flags = 0;
    for (int nb = 0; nb < kNB; ++nb)
      for (int e = 0; e < 4; ++e) {
        if (inside(nb, e)) t[at(nb, e)] = s[nb][e];
        if (tc::near_midpoint(s[nb][e], qn[e / 2] * s_kn[8 * nb + c2 + e % 2]))
          flags |= 1u << (4 * nb + e);
      }
    if (__any_sync(0xffffffffu, flags != 0))
      tc::fix_flagged(s, flags, fix, lane, hd,
                      [&](int src, int code, const bf16*& x, const bf16*& y) {
                        x = s_q + (r0 + src / 4 + 8 * (code % 4 / 2)) * LD;
                        y = s_k + (8 * (code / 4) + 2 * (src % 4) + code % 2)
                                  * LD;
                      });
    for (int nb = 0; nb < kNB; ++nb)
      for (int e = 0; e < 4; ++e)
        if (inside(nb, e)) {
          fixed[at(nb, e)] = s[nb][e];
          seq[at(nb, e)] = tc::seq_dot(
              s_q + (r0 + g + 8 * (e / 2)) * LD,
              s_k + (8 * nb + c2 + e % 2) * LD, hd);
        }
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are (batch, seq, head) in
// elements, for q/k/v/o in the (B, S, heads, hd) layout with a unit
// head-dim stride.  kind: 0 causal, 1 window, 2 chunk, 3 bidir (or cross).
// m_out, l_out: null, or (B, H, Sq) float32 for the row statistics.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* m_out,
    float* l_out, const long long* strides, int B, int H, int K, int Sq,
    int Sk, int hd, int dtype, int kind, int window, float softcap,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || Sq < 1 || Sk < 1 || hd < 1 ||
      hd > 256 || kind < 0 || kind > 3)
    return cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const int G = H / K;
  if (dtype == 0) {
#define REPRO_FA_CASE(HDM)                                                   \
  return launch<float, HDM>(q, k, v, o, m_out, l_out, sq, sk, sv, so, B, H, \
                            Sq, Sk, hd, G, kind, window, softcap, s);
    if (hd <= 64) REPRO_FA_CASE(64)
    if (hd <= 128) REPRO_FA_CASE(128)
    REPRO_FA_CASE(256)
#undef REPRO_FA_CASE
  }
  if (dtype == 1) {
    Bf16Args a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.k = static_cast<const __nv_bfloat16*>(k);
    a.v = static_cast<const __nv_bfloat16*>(v);
    a.o = static_cast<__nv_bfloat16*>(o);
    a.m_out = m_out; a.l_out = l_out;
    a.sq = sq; a.sk = sk; a.sv = sv; a.so = so;
    a.Sq = Sq; a.Sk = Sk; a.hd = hd; a.G = G; a.kind = kind;
    a.window = window;
    a.sqrt_hd = sqrtf((float)hd); a.r_sqrt_hd = 1.0f / a.sqrt_hd;
    a.softcap = softcap; a.r_softcap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
    a.vec = repro_tc::vec_ok(q, sq.b, sq.s, sq.h, hd) &&
            repro_tc::vec_ok(k, sk.b, sk.s, sk.h, hd) &&
            repro_tc::vec_ok(v, sv.b, sv.s, sv.h, hd);
    a.vec_o = repro_tc::vec_ok(o, so.b, so.s, so.h, hd);
    if (hd <= 64) return launch_bf16<64>(a, B, H, s);
    if (hd <= 128) return launch_bf16<128>(a, B, H, s);
    return launch_bf16<256>(a, B, H, s);
  }
  return cudaErrorInvalidValue;
}

// q, k: (S, hd) contiguous bf16 (hd 64 or 128); t, fixed, seq: (S, S)
// float32 (see score_sums_kernel).
extern "C" int flash_attention_score_sums(const void* q, const void* k,
                                          float* t, float* fixed, float* seq,
                                          int S, int hd, void* stream) {
  if (S < 1 || (hd != 64 && hd != 128)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (S + 63) / 64;
  if (hd == 64) {
    const size_t bytes = 2 * 128 * 72 + 4 * 64 +
                         sizeof(repro_tc::FixScratch<8>) * 4;
    score_sums_kernel<64><<<blocks, 128, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), t, fixed, seq, S, hd);
  } else {
    const size_t bytes = 2 * 128 * 136 + 4 * 64 +
                         sizeof(repro_tc::FixScratch<8>) * 4;
    cudaError_t err = cudaFuncSetAttribute(
        score_sums_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    score_sums_kernel<128><<<blocks, 128, bytes, st>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k), t, fixed, seq, S, hd);
  }
  return cudaGetLastError();
}
