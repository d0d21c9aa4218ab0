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
// backward (flash_attention_bwd.cu) reads to recompute the weights bit for
// bit; pass 1 has both already, so this costs one store per row.
//
// Bound on this card: at the serve path's prefill (B 16, H 32, K 8, S 512,
// hd 128, causal) the kernel must read q, k, v and write o, about 168 MB
// (0.050 ms at 3.35 TB/s), and do about 34 GFLOP of products on the causal
// half (0.035 ms at the tensor cores' 989 TFLOP/s bf16, 0.51 ms at 67
// TFLOP/s float32 outside them).  This first version computes with float32
// FMAs from shared memory, so it is bounded by the shared-memory reads of
// its inner products, several times the FMA time; the tensor cores
// (mma.sync / wgmma) are a later change.  At recurrentgemma-2b's prefill
// (B 16, S 512, H 10, K 1, hd 256, window 2048, so causal at S 512) it
// must move about 92 MB (0.028 ms) and do about 21.5 GFLOP of products
// (0.022 ms on the tensor cores).
//
// Design: the TPU kernel's sequential k-block grid axis, with its running
// statistics in VMEM scratch, becomes a loop inside the block.  The TPU
// kernel (online softmax, one pass) never rounds the weights; rounding
// them as the model does needs each row's max and sum before any weight,
// so the loop runs twice over the keys: pass 1 takes the row's running
// max and sum of exponentials from the scores, pass 2 recomputes the
// scores and accumulates the rounded weights times v.  That costs a third
// more products; it keeps the card's model within the bf16 tolerance of
// the host's plain path at full width, which a one-pass float32 kernel
// (max logit gap 0.055 on a 2-layer qwen3-8b) did not.
// A block of 256 threads owns 64 query rows of one (b, h) up to hd 128,
// 32 at hd 256; four threads share a row (eight at hd 256): each holds 8
// (4) of a 32-key tile's scores, the row's max and sum (kept equal in the
// row's threads by shuffles) and a quarter (an eighth) of its output
// accumulator (at most 32 floats) in registers.  q, then each k (and v)
// tile, are staged as float32 in shared memory (rows padded by one word,
// so the threads of a warp fall on distinct banks).  At hd 256 that is
// 102.8 KB (q 32 x 257, k 32 x 257, v 32 x 256 and the weights 32 x 33
// floats), above the 48 KB of static shared memory, so every instance
// takes it as dynamic shared memory.  The causal, window and chunk loops start
// and stop at the first and last tile the block's rows can see, as the
// TPU kernel's `relevant` test does; rows past Sq and keys past Sk (ragged
// tiles) are masked here, so Sq and Sk need not be multiples of any tile.
// Inputs are read through their strides in the model's (B, S, heads, hd)
// layout; no transposed copy is made.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

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

enum Kind { kCausal = 0, kWindow = 1, kChunk = 2, kBidir = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to T (round to nearest even), back in float32
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

struct Strides {
  long long b, s, h;   // elements; the head dim has stride 1
};

__device__ __forceinline__ bool allowed(int kind, int window, int i, int j) {
  if (kind == kBidir) return true;
  bool m = j <= i;
  if (kind == kWindow && window > 0) m = m && (j > i - window);
  if (kind == kChunk && window > 0) m = m && (i / window == j / window);
  return m;
}

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
#define REPRO_FA_CASE(TYPE, HDM)                                              \
  return launch<TYPE, HDM>(q, k, v, o, m_out, l_out, sq, sk, sv, so, B, H, \
                           Sq, Sk, hd, G, kind, window, softcap, s);
  if (dtype == 0) {
    if (hd <= 64) REPRO_FA_CASE(float, 64)
    if (hd <= 128) REPRO_FA_CASE(float, 128)
    REPRO_FA_CASE(float, 256)
  }
  if (dtype == 1) {
    if (hd <= 64) REPRO_FA_CASE(__nv_bfloat16, 64)
    if (hd <= 128) REPRO_FA_CASE(__nv_bfloat16, 128)
    REPRO_FA_CASE(__nv_bfloat16, 256)
  }
#undef REPRO_FA_CASE
  return cudaErrorInvalidValue;
}
