// Flash attention backward (score tile never in device memory), for Hopper.
//
// The reference package has no TPU kernel for this: its
// `flash_attention_trainable` (src/repro/kernels/ops.py:38-67) pairs the
// Pallas forward with `_fat_bwd` (:54), `jax.vjp` of the model's jnp
// attention (models/attention.py `_attend_dense`), which recomputes the
// scores.  This kernel computes that same gradient, at the same rounding
// points, without an S x S tensor in device memory.  For query head h of
// batch row b, kv head h / G, with T the input type (float32 or bf16):
//   r_ij  = q_i . k_j summed in float32, rounded to T
//   x_ij  = r_ij / sqrt(hd); with a softcap c, t_ij = tanh(x_ij / c) and
//           x_ij = c t_ij; refused (i, j) take no part (as the forward)
//   y_ij  = exp(x_ij - m_i) / l_i, from the forward's row max m_i and sum
//           of exponentials l_i
//   w_ij  = y_ij rounded to T (what multiplied v in the forward)
//   dw_ij = dO_i . v_j summed in float32, rounded to T
//   D_i   = sum_j dw_ij y_ij                       (float32)
//   ds_ij = y_ij (dw_ij - D_i), times (1 - t_ij^2) with a softcap
//   dr_ij = ds_ij / sqrt(hd), rounded to T
//   dq_i  = sum_j dr_ij k_j,  dk_j = sum_{g,i} dr_ij q_i,
//   dv_j  = sum_{g,i} w_ij dO_i: each summed in float32 over the G query
//           heads of the kv head and every query, rounded once to T.
// D_i is taken from the rounded dw as the model's gradient takes it (the
// softmax backward of the float32 y); flash-attention-2's rowsum(dO o O)
// is the same in exact arithmetic but not at these roundings.  y is the
// forward's softmax bit for bit only if r_ij is the forward's float32 sum
// bit for bit: the bf16 kernels compute q.k (and k.q in the dk/dv pass)
// on the tensor cores and take the sums near a bf16 rounding midpoint
// again in order, as the forward does (flash_attention.cu, "Exact sums"),
// so every r_ij rounds as the plain version's and the forward's, and the
// recomputed weights of a row sum to 1 within float32 rounding (a card
// test checks it: with every v_j equal, dq and dk vanish only then).
//
// Bound on this card (H100 SXM, 989 TFLOP/s bf16 dense, 3.35 TB/s): five
// products of the score shape (q.k again, dO.v, w^T dO, dr k, dr^T q).
// At qwen3-8b's training head layout (B 1, S 4096, H 32, K 8, hd 128,
// causal) that is about 344 GFLOP, 0.35 ms; the bytes (q, k, v, dO read,
// dq, dk, dv written, ~80 MB) take 0.024 ms.  At repro-100m's microbatch
// (B 4, S 256, H 12, hd 64) the bytes bound it, 0.0033 ms.  Both kernels
// together do nine products, not five: the dq pass takes q.k and dO.v
// twice, once for D and once for ds, and the dk/dv pass takes them again.
// PERF.md has the times (chip_smoke.py).
//
// Design, deterministic (no atomics): two kernels on one stream.
//   1. dq pass, one block per (query block of 64, head, batch row): sweep
//      1 over the row's keys accumulates D_i (written to a float32
//      scratch (B, H, Sq) for pass 2), sweep 2 recomputes y and dw, forms
//      dr, and accumulates dq.  5 products a key tile.
//   2. dk/dv pass, one block per (key block of 64, kv head, batch row): k
//      and v of the block stay in shared memory; the block walks the G
//      query heads and, for each, every tile of queries that can see its
//      keys (causal, window and chunk stop where the mask does), taking
//      S^T = k q^T and dW^T = v dO^T, then dv += w^T dO and dk += dr^T q.
//      4 products a query tile.
//
// bf16 (the training path): the tensor cores, as in the forward
// (tensor_core.cuh).  A block is 4 warps, 16 rows (dq pass: queries;
// dk/dv pass: keys) a warp.  Every product is mma.sync m16n8k16 on
// fragments that ldmatrix reads from shared memory (.trans for k in
// dr . k, and for dO and q in w^T dO and dr^T q); dr (and w) go straight
// from the C fragments of the score tile to the A fragments of the next
// product, exactly, since the model rounds them to bf16.  The dq pass
// keeps q and dO of its 64 rows in shared memory and double-buffers the
// 64-key tiles of k and v with 16-byte cp.async; sweep 1 takes the sums
// near a rounding midpoint again and logs the changed ones, sweep 2 sets
// them from the log.  The dk/dv pass keeps k and v of its 64 keys and
// double-buffers the query tiles of q, dO and their m, l, D (32 queries
// up to hd 128, 64 at hd 64), taking the flagged sums again in every
// tile.  One barrier a tile: tile u + 1 is issued after the barrier that
// ends tile u - 1, and each thread takes the norms (and 1 / l) of the
// rows it copied itself.  Registers: the dq pass holds a thread's dq
// (hd / 2 floats) and two 64-key score tiles (64 floats); the dk/dv pass
// dk and dv (hd floats) and two score tiles of 32 queries at hd 128 (64
// at hd 64); ptxas fits every instance in 255 registers without a spill
// (PERF.md).  Refused pairs take a huge negative sum before the weights,
// so y is 0 with no test in the common loop (with a softcap, which maps
// it to -softcap, the refused pairs are told to the loop instead).  Each
// warp classifies each tile as the forward does.  16-byte copies need q,
// k, v, dO 16-byte aligned with strides and hd multiples of 8 elements;
// otherwise the same kernels load element by element.  Rows past Sq or
// Sk and columns past hd are zero-filled.
//
// float32 (the whole-model float32 checks only): the first version,
// float32 FMAs from float32 tiles in shared memory, unchanged: 256
// threads, 4 per query row (dq pass) or key (dk/dv pass), 32-key and
// 32-query tiles, dr and w through shared memory.
//
// Inputs are read through their strides in the model's (B, S, heads, hd)
// layout (unit stride in the head dim).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerRow = 4;           // threads per query row (dq) or key (dkv)
constexpr int kBQ = 64;              // dq pass: query rows per block
constexpr int kBK = 32;              // dq pass: keys per tile
constexpr int kBKV = 64;             // dkv pass: keys per block
constexpr int kBQT = 32;             // dkv pass: queries per tile
constexpr int kCols = 32 / kPerRow;  // products per thread per tile
constexpr float kNegInf = -0.7f * FLT_MAX;

// the mask kinds and their test, shared with the bf16 instances
using repro_tc::allowed;
using repro_tc::kBidir;
using repro_tc::kChunk;
using repro_tc::kWindow;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ float round_to(float x, float) { return x; }

struct Strides {
  long long b, s, h;   // elements; the head dim has stride 1
};

struct Args {
  const void *q, *k, *v, *dout;
  const float *m, *l;
  float* D;
  void *dq, *dk, *dv;
  Strides sq, sk, sv, sdo, sdq, sdk, sdv;
  int H, G, Sq, Sk, hd, kind, window;
  float sqrt_hd, softcap;
  // bf16 kernels: 1 / sqrt(hd) and 1 / softcap rounded to nearest, and
  // whether q, k, v, dO take 16-byte copies (tensor_core.cuh)
  float r_sqrt_hd, r_softcap;
  bool vec;
};

// One (i, j) pair from its two raw dot products: y (the forward's float32
// softmax weight), dw (rounded), and t = tanh(x / softcap) with a softcap.
template <typename T>
__device__ __forceinline__ void pair(const Args& a, float sdot, float dwdot,
                                     int i, int j, float m, float l,
                                     float& y, float& dw, float& t) {
  float x = round_to(sdot, T()) / a.sqrt_hd;
  t = 0.0f;
  if (a.softcap > 0.0f) {
    t = tanhf(x / a.softcap);
    x = a.softcap * t;
  }
  const bool ok = i < a.Sq && j < a.Sk && allowed(a.kind, a.window, i, j);
  y = (ok && l > 0.0f) ? expf(x - m) / l : 0.0f;
  dw = round_to(dwdot, T());
}

template <typename T>
__device__ __forceinline__ float score_grad(const Args& a, float y, float dw,
                                            float D, float t) {
  float ds = y * (dw - D);
  if (a.softcap > 0.0f) ds = ds * (1.0f - t * t);
  return round_to(ds / a.sqrt_hd, T());
}

// Pass 1: dq and D, one block per (query block, head, batch row).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int kAcc = HD / kPerRow;
  extern __shared__ float smem[];
  float* s_q = smem;                  // [kBQ][LD]
  float* s_do = s_q + kBQ * LD;       // [kBQ][LD]
  float* s_k = s_do + kBQ * LD;       // [kBK][LD]
  float* s_v = s_k + kBK * LD;        // [kBK][LD]
  float* s_p = s_v + kBK * LD;        // [kBQ][kBK + 1]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / a.G;
  const int r = tid / kPerRow;
  const int part = tid % kPerRow;
  const int i = q0 + r;

  const T* qb = q + b * a.sq.b + h * a.sq.h;
  const T* dob = dout + b * a.sdo.b + h * a.sdo.h;
  const T* kb = k + b * a.sk.b + kvh * a.sk.h;
  const T* vb = v + b * a.sv.b + kvh * a.sv.h;
  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int rr = e / HD, d = e % HD;
    const int qi = q0 + rr;
    const bool in = qi < a.Sq && d < a.hd;
    s_q[rr * LD + d] = in ? to_f(qb[qi * a.sq.s + d]) : 0.0f;
    s_do[rr * LD + d] = in ? to_f(dob[qi * a.sdo.s + d]) : 0.0f;
  }
  const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq + i;
  const float m = i < a.Sq ? a.m[row] : 0.0f;
  const float l = i < a.Sq ? a.l[row] : 0.0f;

  const int i_last = min(q0 + kBQ, a.Sq) - 1;
  int k_lo = 0, k_hi = a.Sk;
  if (a.kind != kBidir) {
    k_hi = min(a.Sk, i_last + 1);
    if (a.kind == kWindow && a.window > 0) k_lo = max(0, q0 - a.window + 1);
    if (a.kind == kChunk && a.window > 0) k_lo = (q0 / a.window) * a.window;
  }
  k_lo = (k_lo / kBK) * kBK;

  auto load_tile = [&](int k0) {
    __syncthreads();
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int c = e / HD, d = e % HD;
      const int kj = k0 + c;
      const bool in = kj < a.Sk && d < a.hd;
      s_k[c * LD + d] = in ? to_f(kb[kj * a.sk.s + d]) : 0.0f;
      s_v[c * LD + d] = in ? to_f(vb[kj * a.sv.s + d]) : 0.0f;
    }
    __syncthreads();
  };
  // this thread's kCols pairs of the tile: y, dw, t
  auto tile = [&](int k0, float (&y)[kCols], float (&dw)[kCols],
                  float (&t)[kCols]) {
    float s[kCols], w[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = w[c] = 0.0f;
    const float* qrow = s_q + r * LD;
    const float* dorow = s_do + r * LD;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      const float qd = qrow[d], dod = dorow[d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kc = (part + kPerRow * c) * LD + d;
        s[c] = fmaf(qd, s_k[kc], s[c]);
        w[c] = fmaf(dod, s_v[kc], w[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      pair<T>(a, s[c], w[c], i, k0 + part + kPerRow * c, m, l, y[c], dw[c],
              t[c]);
  };

  // sweep 1: D_i
  float D = 0.0f;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    load_tile(k0);
    float y[kCols], dw[kCols], t[kCols];
    tile(k0, y, dw, t);
#pragma unroll
    for (int c = 0; c < kCols; ++c) D = fmaf(dw[c], y[c], D);
  }
  D += __shfl_xor_sync(0xffffffffu, D, 1);
  D += __shfl_xor_sync(0xffffffffu, D, 2);

  // sweep 2: dq
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
  for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
    load_tile(k0);
    float y[kCols], dw[kCols], t[kCols];
    tile(k0, y, dw, t);
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      s_p[r * (kBK + 1) + part + kPerRow * c] =
          score_grad<T>(a, y[c], dw[c], D, t[c]);
    __syncwarp();      // the row's dr, written by its four lanes of one warp
    const float* prow = s_p + r * (kBK + 1);
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float dr = prow[c];
      const float* krow = s_k + c * LD + part;
#pragma unroll
      for (int e = 0; e < kAcc; ++e)
        acc[e] = fmaf(dr, krow[kPerRow * e], acc[e]);
    }
  }

  if (i < a.Sq) {
    if (part == 0) a.D[row] = D;
    T* dqrow = static_cast<T*>(a.dq) + b * a.sdq.b + i * a.sdq.s +
               h * a.sdq.h;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int d = part + kPerRow * e;
      if (d < a.hd) from_f(dqrow + d, acc[e]);
    }
  }
}

// Pass 2: dk and dv, one block per (key block, kv head, batch row).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) dkv_kernel(Args a) {
  constexpr int LD = HD + 1;
  constexpr int kAcc = HD / kPerRow;
  extern __shared__ float smem[];
  float* s_k = smem;                  // [kBKV][LD]
  float* s_v = s_k + kBKV * LD;       // [kBKV][LD]
  float* s_q = s_v + kBKV * LD;       // [kBQT][LD]
  float* s_do = s_q + kBQT * LD;      // [kBQT][LD]
  float* s_w = s_do + kBQT * LD;      // [kBKV][kBQT + 1]
  float* s_dr = s_w + kBKV * (kBQT + 1);   // [kBKV][kBQT + 1]
  float* s_m = s_dr + kBKV * (kBQT + 1);   // [kBQT]
  float* s_l = s_m + kBQT;                 // [kBQT]
  float* s_D = s_l + kBQT;                 // [kBQT]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kBKV;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int r = tid / kPerRow;        // this thread's key
  const int part = tid % kPerRow;
  const int j = j0 + r;

  const T* kb = k + b * a.sk.b + kvh * a.sk.h;
  const T* vb = v + b * a.sv.b + kvh * a.sv.h;
  for (int e = tid; e < kBKV * HD; e += kThreads) {
    const int c = e / HD, d = e % HD;
    const int kj = j0 + c;
    const bool in = kj < a.Sk && d < a.hd;
    s_k[c * LD + d] = in ? to_f(kb[kj * a.sk.s + d]) : 0.0f;
    s_v[c * LD + d] = in ? to_f(vb[kj * a.sv.s + d]) : 0.0f;
  }

  // the queries that can see this block's keys
  const int j_last = min(j0 + kBKV, a.Sk) - 1;
  int i_lo = 0, i_hi = a.Sq;             // [i_lo, i_hi)
  if (a.kind != kBidir) {
    i_lo = j0;
    if (a.kind == kWindow && a.window > 0)
      i_hi = min(a.Sq, j_last + a.window);
    if (a.kind == kChunk && a.window > 0)
      i_hi = min(a.Sq, (j_last / a.window + 1) * a.window);
  }
  i_lo = (i_lo / kBQT) * kBQT;

  float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc_k[e] = acc_v[e] = 0.0f;

  for (int g = 0; g < a.G; ++g) {
    const int h = kvh * a.G + g;
    const T* qb = q + b * a.sq.b + h * a.sq.h;
    const T* dob = dout + b * a.sdo.b + h * a.sdo.h;
    const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
    for (int i0 = i_lo; i0 < i_hi; i0 += kBQT) {
      __syncthreads();   // the previous tile's q, dO, w and dr are consumed
      for (int e = tid; e < kBQT * HD; e += kThreads) {
        const int c = e / HD, d = e % HD;
        const int qi = i0 + c;
        const bool in = qi < a.Sq && d < a.hd;
        s_q[c * LD + d] = in ? to_f(qb[qi * a.sq.s + d]) : 0.0f;
        s_do[c * LD + d] = in ? to_f(dob[qi * a.sdo.s + d]) : 0.0f;
      }
      if (tid < kBQT) {
        const int qi = i0 + tid;
        const bool in = qi < a.Sq;
        s_m[tid] = in ? a.m[row0 + qi] : 0.0f;
        s_l[tid] = in ? a.l[row0 + qi] : 0.0f;
        s_D[tid] = in ? a.D[row0 + qi] : 0.0f;
      }
      __syncthreads();
      float s[kCols], w[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[c] = w[c] = 0.0f;
      const float* krow = s_k + r * LD;
      const float* vrow = s_v + r * LD;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        const float kd = krow[d], vd = vrow[d];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int qc = (part + kPerRow * c) * LD + d;
          s[c] = fmaf(s_q[qc], kd, s[c]);
          w[c] = fmaf(s_do[qc], vd, w[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int ci = part + kPerRow * c;
        float y, dw, t;
        pair<T>(a, s[c], w[c], i0 + ci, j, s_m[ci], s_l[ci], y, dw, t);
        s_w[r * (kBQT + 1) + ci] = round_to(y, T());
        s_dr[r * (kBQT + 1) + ci] = score_grad<T>(a, y, dw, s_D[ci], t);
      }
      __syncwarp();    // the key's w and dr, written by its four lanes
      const float* wrow = s_w + r * (kBQT + 1);
      const float* drrow = s_dr + r * (kBQT + 1);
#pragma unroll 4
      for (int c = 0; c < kBQT; ++c) {
        const float wc = wrow[c], drc = drrow[c];
        const float* qrow = s_q + c * LD + part;
        const float* dorow = s_do + c * LD + part;
#pragma unroll
        for (int e = 0; e < kAcc; ++e) {
          acc_v[e] = fmaf(wc, dorow[kPerRow * e], acc_v[e]);
          acc_k[e] = fmaf(drc, qrow[kPerRow * e], acc_k[e]);
        }
      }
    }
  }

  if (j < a.Sk) {
    T* dkrow = static_cast<T*>(a.dk) + b * a.sdk.b + j * a.sdk.s +
               kvh * a.sdk.h;
    T* dvrow = static_cast<T*>(a.dv) + b * a.sdv.b + j * a.sdv.s +
               kvh * a.sdv.h;
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int d = part + kPerRow * e;
      if (d < a.hd) {
        from_f(dkrow + d, acc_k[e]);
        from_f(dvrow + d, acc_v[e]);
      }
    }
  }
}

template <typename T, int HD>
int launch(const Args& a, int B, int K, cudaStream_t stream) {
  constexpr int LD = HD + 1;
  const size_t dq_bytes = sizeof(float) *
      (2 * kBQ * LD + 2 * kBK * LD + kBQ * (kBK + 1));
  const size_t dkv_bytes = sizeof(float) *
      (2 * kBKV * LD + 2 * kBQT * LD + 2 * kBKV * (kBQT + 1) + 3 * kBQT);
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dq_bytes);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dkv_bytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dq_kernel<T, HD><<<dim3((a.Sq + kBQ - 1) / kBQ, a.H, B), kThreads,
                     dq_bytes, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_kernel<T, HD><<<dim3((a.Sk + kBKV - 1) / kBKV, K, B), kThreads,
                      dkv_bytes, stream>>>(a);
  return cudaGetLastError();
}

// ---- bf16: the tensor cores ---------------------------------------------

namespace tc = repro_tc;

constexpr int kTcWarps = 4;          // 16 rows each
constexpr int kTcThreads = 32 * kTcWarps;

template <int HD>
struct Bf16Bwd {
  static constexpr int kLD = HD + 8;               // padded row, elements
  static constexpr int kBQ = 64;                   // dq: query rows a block
  static constexpr int kBK = 64;                   // dq: keys a tile
  static constexpr int kBKV = 64;                  // dk/dv: keys a block
  static constexpr int kBQT = HD > 64 ? 32 : 64;   // dk/dv: queries a tile
  static constexpr size_t kLog = (sizeof(int) + sizeof(float)) *
                                 tc::kFlipCap * kTcWarps;   // dq's flip log
  static constexpr size_t dq_bytes() {   // q, dO, 2 x (k, v), norms
    return sizeof(__nv_bfloat16) * (2 * kBQ + 4 * kBK) * kLD +
           sizeof(float) * (2 * kBK + 4) +
           sizeof(tc::FixScratch<kBK / 8>) * kTcWarps + kLog;
  }
  static constexpr size_t dkv_bytes() {  // k, v, 2 x (q, dO, m l D 1/l),
    return sizeof(__nv_bfloat16) * (2 * kBKV + 4 * kBQT) * kLD +   // norms
           sizeof(float) * (2 * 4 * kBQT + 2 * kBQT) +
           sizeof(tc::FixScratch<kBQT / 8>) * kTcWarps;
  }
};

// A q.k sum that no weight can come from: with no softcap, refused pairs
// take it before pair_grad (x is then about -3e37, and y exactly 0).
constexpr float kRefused = -3.0e38f;

// One pair's softmax weight y = exp(x - m) / l (0 where `ok` is false, or
// where l is 0, and so rl) and, with kDr, its score gradient dr =
// round(y (dw - D) (1 - t^2) / sqrt(hd)), t = tanh(x / softcap), from the
// raw float32 sums of q.k and dO.v; as `pair` and `score_grad`, with
// Markstein divisions.
template <bool kCap, bool kDr>
__device__ __forceinline__ void pair_grad(const Args& a, float sdot,
                                          float dwdot, bool ok, float m,
                                          float l, float rl, float D,
                                          float& y, float& dr) {
  float x = tc::div_rn(tc::round_bf16(sdot), a.sqrt_hd, a.r_sqrt_hd);
  float t = 0.0f;
  if constexpr (kCap) {
    t = tanhf(tc::div_rn(x, a.softcap, a.r_softcap));
    x = a.softcap * t;
  }
  y = ok ? tc::div_rn(expf(x - m), l, rl) : 0.0f;
  if constexpr (kDr) {
    float ds = y * (tc::round_bf16(dwdot) - D);
    if constexpr (kCap) ds = ds * (1.0f - t * t);
    dr = tc::round_bf16(tc::div_rn(ds, a.sqrt_hd, a.r_sqrt_hd));
  }
}

// Pass 1, bf16: dq and D, one block per (query block, head, batch row).
template <int HD>
__global__ void __launch_bounds__(kTcThreads) dq_bf16_kernel(Args a) {
  using Cfg = Bf16Bwd<HD>;
  using tc::bf16;
  constexpr int kBQ = Cfg::kBQ, kBK = Cfg::kBK, LD = Cfg::kLD;
  constexpr int kNB = kBK / 8, kKS = HD / 16, kND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* s_q = reinterpret_cast<bf16*>(smem_tc);   // [kBQ][LD]
  bf16* s_do = s_q + kBQ * LD;                    // [kBQ][LD]
  bf16* s_k = s_do + kBQ * LD;                    // [2][kBK][LD]
  bf16* s_v = s_k + 2 * kBK * LD;                 // [2][kBK][LD]
  float* s_kn = reinterpret_cast<float*>(s_v + 2 * kBK * LD);  // [2][kBK]
  int* s_full = reinterpret_cast<int*>(s_kn + 2 * kBK);   // a log is full
  auto* s_fix = reinterpret_cast<tc::FixScratch<kNB>*>(s_full + 4);
  int* s_flip = reinterpret_cast<int*>(s_fix + kTcWarps);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  tc::FlipLog flog;                  // sweep 1's changed roundings
  flog.code = s_flip + tc::kFlipCap * warp;
  flog.val = reinterpret_cast<float*>(s_flip + tc::kFlipCap * kTcWarps) +
             tc::kFlipCap * warp;
  int cursor = 0;                    // sweep 2's place in the log
  tc::FixScratch<kNB>& fix = s_fix[warp];
  fix.flips[lane] = 0;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / a.G;
  const int r0 = 16 * warp, wi = q0 + r0;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + h * a.sq.h;
  const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.sdo.b +
                    h * a.sdo.h;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b +
                   kvh * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b +
                   kvh * a.sv.h;
  const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;

  const int i_last = min(q0 + kBQ, a.Sq) - 1;
  int k_lo = 0, k_hi = a.Sk;
  if (a.kind != tc::kBidir) {
    k_hi = min(a.Sk, i_last + 1);
    if (a.kind == tc::kWindow && a.window > 0)
      k_lo = max(0, q0 - a.window + 1);
    if (a.kind == tc::kChunk && a.window > 0)
      k_lo = (q0 / a.window) * a.window;
  }
  k_lo = (k_lo / kBK) * kBK;
  const int n = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  // tile u < n: sweep 1 over keys k_lo + u kBK; n <= u < 2n: sweep 2.
  // As in the forward: tile u + 1 is issued after the barrier that ends
  // tile u - 1, and each thread takes its part of the tile's key norms
  // from its own copies (sweep 2 needs them only where a warp's log
  // overflowed).
  auto key0 = [&](int u) { return k_lo + (u < n ? u : u - n) * kBK; };
  auto issue = [&](int u) {
    if (u < 2 * n) {
      const int st = (u % 2) * kBK * LD;
      tc::load_rows<kBK, HD, kTcThreads>(s_k + st, LD, kb, a.sk.s, key0(u),
                                         a.Sk, a.hd, a.vec, tid);
      tc::load_rows<kBK, HD, kTcThreads>(s_v + st, LD, vb, a.sv.s, key0(u),
                                         a.Sk, a.hd, a.vec, tid);
    }
    tc::cp_async_commit();
  };
  tc::load_rows<kBQ, HD, kTcThreads>(s_q, LD, qb, a.sq.s, q0, a.Sq, a.hd,
                                     a.vec, tid);
  tc::load_rows<kBQ, HD, kTcThreads>(s_do, LD, dob, a.sdo.s, q0, a.Sq, a.hd,
                                     a.vec, tid);
  issue(0);
  tc::cp_async_wait<0>();
  if (n > 0) tc::own_row_norms<kBK, HD, kTcThreads>(s_kn, s_k, LD, tid);
  if (tid == 0) *s_full = 0;

  float m[2], l[2], rl[2], qn[2], D[2] = {0.0f, 0.0f};   // rows g, g + 8
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wi + g + 8 * r;
    m[r] = i < a.Sq ? a.m[row0 + i] : 0.0f;
    l[r] = i < a.Sq ? a.l[row0 + i] : 0.0f;
    rl[r] = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
  }
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
      tc::quad_norms(s_q + (r0 + g) * LD, s_q + (r0 + g + 8) * LD, a.hd,
                     lane, qn[0], qn[1]);
      qn[0] *= tc::kSumTol;
      qn[1] *= tc::kSumTol;
    }
    if (u == n) {                    // sweep 1 done: the row's whole D
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        D[r] += __shfl_xor_sync(0xffffffffu, D[r], 1);
        D[r] += __shfl_xor_sync(0xffffffffu, D[r], 2);
      }
    }
    const bool sweep2 = u >= n;
    const int k0 = k_lo + (sweep2 ? u - n : u) * kBK;
    const int cls = tc::tile_class(a.kind, a.window, wi, wi + 15, k0,
                                   k0 + kBK - 1, a.Sq, a.Sk);
    if (cls != tc::kNone) {
      // S = q k^T (as the forward) and dW = dO v^T
      float s[kNB][4], dw[kNB][4];
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = dw[nb][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t aq[4], ado[4];
        tc::load_a(aq, s_q, LD, r0, 16 * kk, lane);
        tc::load_a(ado, s_do, LD, r0, 16 * kk, lane);
#pragma unroll
        for (int nb = 0; nb < kNB; nb += 2) {
          uint32_t bb[4];
          tc::load_b_rows(bb, t_k, LD, 8 * nb, 16 * kk, lane);
          tc::mma(s[nb], aq, bb[0], bb[1]);
          tc::mma(s[nb + 1], aq, bb[2], bb[3]);
          tc::load_b_rows(bb, t_v, LD, 8 * nb, 16 * kk, lane);
          tc::mma(dw[nb], ado, bb[0], bb[1]);
          tc::mma(dw[nb + 1], ado, bb[2], bb[3]);
        }
      }
      // sweep 1 takes the q.k sums near a bf16 rounding midpoint again in
      // order and logs those whose rounding changes; sweep 2 sets the
      // logged ones (element e of block nb: row g + 8 (e / 2), key 8 nb +
      // c2 + e % 2)
      if (!sweep2 || flog.full) {
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
              s, flags, fix, lane, a.hd,
              [&](int src, int code, const bf16*& x, const bf16*& y) {
                x = s_q + (r0 + src / 4 + 8 * (code % 4 / 2)) * LD;
                y = t_k + (8 * (code / 4) + 2 * (src % 4) + code % 2) * LD;
              });
        if (!sweep2 && __any_sync(0xffffffffu, flips != 0)) {
          tc::log_flips(flog, fix, flips, u, lane);
          if (flog.full && lane == 0) *s_full = 1;
        }
      } else {
        tc::replay_flips(flog, s, cursor, u - n, lane);
      }
      // y and dr of each pair; sweep 1 sums D, sweep 2 keeps dr in s
      const bool cap = a.softcap > 0.0f;
      if (!cap)
        tc::mask_rows(s, cls, a.kind, a.window, wi, k0, g, c2, a.Sq, a.Sk,
                      kRefused);
      // (with a softcap, the refused pairs are told to pair_grad)
      const uint32_t refused =
          !cap || cls == tc::kFull ? 0u
              : tc::refused_bits<kNB>(a.kind, a.window, wi + g, k0 + c2,
                                      a.Sq, a.Sk, true);
      auto pairs = [&](auto kcap, auto kdr) {
        constexpr bool kCap = decltype(kcap)::value;
        constexpr bool kDr = decltype(kdr)::value;
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e / 2;
            const bool ok = !kCap || !((refused >> (4 * nb + e)) & 1u);
            float y, dr;
            pair_grad<kCap, kDr>(a, s[nb][e], dw[nb][e], ok, m[r], l[r],
                                 rl[r], D[r], y, dr);
            if constexpr (kDr)
              s[nb][e] = dr;
            else
              D[r] = fmaf(tc::round_bf16(dw[nb][e]), y, D[r]);
          }
      };
      using T_ = std::true_type;
      using F_ = std::false_type;
      if (cap) {
        if (sweep2) pairs(T_(), T_()); else pairs(T_(), F_());
      } else {
        if (sweep2) pairs(F_(), T_()); else pairs(F_(), F_());
      }
      if (sweep2) {
        // dq += dr k, dr packed from the C fragments
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
            tc::load_b_cols(bb, t_k, LD, 16 * kk, 8 * nd, lane);
            tc::mma(acc[nd], p, bb[0], bb[1]);
            tc::mma(acc[nd + 1], p, bb[2], bb[3]);
          }
        }
      }
    }
    if (norms_next) {
      tc::cp_async_wait<0>();        // this thread's copies of tile u + 1
      tc::own_row_norms<kBK, HD, kTcThreads>(s_kn + ((u + 1) % 2) * kBK,
                                             s_k + ((u + 1) % 2) * kBK * LD,
                                             LD, tid);
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = wi + g + 8 * r;
    if (i >= a.Sq) continue;
    if (c2 == 0) a.D[row0 + i] = D[r];
    bf16* dqrow = static_cast<bf16*>(a.dq) + b * a.sdq.b + i * a.sdq.s +
                  h * a.sdq.h;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = 8 * nd + c2 + t;
        if (d < a.hd) dqrow[d] = __float2bfloat16_rn(acc[nd][2 * r + t]);
      }
  }
}

// Pass 2, bf16: dk and dv, one block per (key block, kv head, batch row).
template <int HD>
__global__ void __launch_bounds__(kTcThreads) dkv_bf16_kernel(Args a) {
  using Cfg = Bf16Bwd<HD>;
  using tc::bf16;
  constexpr int kBKV = Cfg::kBKV, kBQT = Cfg::kBQT, LD = Cfg::kLD;
  constexpr int kNQ = kBQT / 8, kKS = HD / 16, kND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  bf16* s_k = reinterpret_cast<bf16*>(smem_tc);   // [kBKV][LD]
  bf16* s_v = s_k + kBKV * LD;                    // [kBKV][LD]
  bf16* s_q = s_v + kBKV * LD;                    // [2][kBQT][LD]
  bf16* s_do = s_q + 2 * kBQT * LD;               // [2][kBQT][LD]
  float* s_st = reinterpret_cast<float*>(s_do + 2 * kBQT * LD);
                                          // [2][m, l, D, 1 / l][kBQT]
  float* s_qn = s_st + 2 * 4 * kBQT;      // [2][kBQT]
  auto* s_fix = reinterpret_cast<tc::FixScratch<kNQ>*>(s_qn + 2 * kBQT);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int j0 = blockIdx.x * kBKV;   // causal: the first keys see most
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = 16 * warp, wj = j0 + r0;
  tc::FixScratch<kNQ>& fix = s_fix[warp];
  fix.flips[lane] = 0;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b +
                   kvh * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b +
                   kvh * a.sv.h;

  // the queries that can see this block's keys
  const int j_last = min(j0 + kBKV, a.Sk) - 1;
  int i_lo = 0, i_hi = a.Sq;             // [i_lo, i_hi)
  if (a.kind != tc::kBidir) {
    i_lo = j0;
    if (a.kind == tc::kWindow && a.window > 0)
      i_hi = min(a.Sq, j_last + a.window);
    if (a.kind == tc::kChunk && a.window > 0)
      i_hi = min(a.Sq, (j_last / a.window + 1) * a.window);
  }
  i_lo = (i_lo / kBQT) * kBQT;
  const int n_i = i_hi > i_lo ? (i_hi - i_lo + kBQT - 1) / kBQT : 0;
  const int n = a.G * n_i;               // tiles: (query head, query tile)

  // tile u: query head kvh G + u / n_i, queries i_lo + (u % n_i) kBQT;
  // stage u % 2.  As in the forward: tile u + 1 is issued after the
  // barrier that ends tile u - 1, and each thread takes its part of the
  // tile's query norms and 1 / l from its own copies.
  auto head = [&](int u) { return kvh * a.G + u / n_i; };
  auto query0 = [&](int u) { return i_lo + (u % n_i) * kBQT; };
  auto issue = [&](int u) {
    if (u < n) {
      const int h = head(u), i0 = query0(u);
      const int st = (u % 2) * kBQT * LD;
      const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b +
                       h * a.sq.h;
      const bf16* dob = static_cast<const bf16*>(a.dout) + b * a.sdo.b +
                        h * a.sdo.h;
      tc::load_rows<kBQT, HD, kTcThreads>(s_q + st, LD, qb, a.sq.s, i0,
                                          a.Sq, a.hd, a.vec, tid);
      tc::load_rows<kBQT, HD, kTcThreads>(s_do + st, LD, dob, a.sdo.s, i0,
                                          a.Sq, a.hd, a.vec, tid);
      const long long row0 = (static_cast<long long>(b) * a.H + h) * a.Sq;
      float* dst = s_st + (u % 2) * 4 * kBQT;
      for (int c = tid; c < 3 * kBQT; c += kTcThreads) {
        const int which = c / kBQT, ci = c % kBQT;
        const float* src = which == 0 ? a.m : which == 1 ? a.l : a.D;
        const bool ok = i0 + ci < a.Sq;
        tc::cp_async4(dst + c, ok ? src + row0 + i0 + ci : src, ok ? 4 : 0);
      }
    }
    tc::cp_async_commit();
  };
  // the query norms and 1 / l of the tile in stage st, from this
  // thread's own copies (after it waited for them)
  auto side = [&](int st) {
    tc::own_row_norms<kBQT, HD, kTcThreads>(s_qn + st * kBQT,
                                            s_q + st * kBQT * LD, LD, tid);
    float* t_st = s_st + st * 4 * kBQT;
    for (int c = tid; c < 3 * kBQT; c += kTcThreads)
      if (c >= kBQT && c < 2 * kBQT)
        t_st[2 * kBQT + c] = t_st[c] > 0.0f ? 1.0f / t_st[c] : 0.0f;
  };
  tc::load_rows<kBKV, HD, kTcThreads>(s_k, LD, kb, a.sk.s, j0, a.Sk, a.hd,
                                      a.vec, tid);
  tc::load_rows<kBKV, HD, kTcThreads>(s_v, LD, vb, a.sv.s, j0, a.Sk, a.hd,
                                      a.vec, tid);
  issue(0);
  tc::cp_async_wait<0>();
  if (n > 0) side(0);

  float kn[2];                           // |k| of keys g, g + 8, scaled
  float dk[kND][4], dv[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nd][e] = dv[nd][e] = 0.0f;

  for (int u = 0; u < n; ++u) {
    tc::cp_async_wait<0>();
    __syncthreads();                 // tile u in shared memory; u - 1 done
    issue(u + 1);
    const int i0 = query0(u);
    const bf16* t_q = s_q + (u % 2) * kBQT * LD;
    const bf16* t_do = s_do + (u % 2) * kBQT * LD;
    const float* t_st = s_st + (u % 2) * 4 * kBQT;   // m, l, D, 1 / l
    const float* t_qn = s_qn + (u % 2) * kBQT;
    if (u == 0) {
      tc::quad_norms(s_k + (r0 + g) * LD, s_k + (r0 + g + 8) * LD, a.hd,
                     lane, kn[0], kn[1]);
      kn[0] *= tc::kSumTol;
      kn[1] *= tc::kSumTol;
    }
    const int cls = tc::tile_class(a.kind, a.window, i0, i0 + kBQT - 1, wj,
                                   wj + 15, a.Sq, a.Sk);
    if (cls != tc::kNone) {
      // S^T = k q^T and dW^T = v dO^T: rows are this warp's keys
      float s[kNQ][4], dw[kNQ][4];
#pragma unroll
      for (int nq = 0; nq < kNQ; ++nq)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nq][e] = dw[nq][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t ak[4], av[4];
        tc::load_a(ak, s_k, LD, r0, 16 * kk, lane);
        tc::load_a(av, s_v, LD, r0, 16 * kk, lane);
#pragma unroll
        for (int nq = 0; nq < kNQ; nq += 2) {
          uint32_t bb[4];
          tc::load_b_rows(bb, t_q, LD, 8 * nq, 16 * kk, lane);
          tc::mma(s[nq], ak, bb[0], bb[1]);
          tc::mma(s[nq + 1], ak, bb[2], bb[3]);
          tc::load_b_rows(bb, t_do, LD, 8 * nq, 16 * kk, lane);
          tc::mma(dw[nq], av, bb[0], bb[1]);
          tc::mma(dw[nq + 1], av, bb[2], bb[3]);
        }
      }
      // the k.q sums near a bf16 rounding midpoint, in order (element e
      // of block nq: key g + 8 (e / 2), query 8 nq + c2 + e % 2)
      uint32_t flags = 0;
#pragma unroll
      for (int nq = 0; nq < kNQ; ++nq) {
        const float2 qn = *reinterpret_cast<const float2*>(t_qn + 8 * nq +
                                                           c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tc::near_midpoint(s[nq][e], kn[e / 2] * (e % 2 ? qn.y : qn.x)))
            flags |= 1u << (4 * nq + e);
      }
      if (__any_sync(0xffffffffu, flags != 0))
        tc::fix_flagged(s, flags, fix, lane, a.hd,
                        [&](int src, int code, const bf16*& x,
                            const bf16*& y) {
                          x = t_q + (8 * (code / 4) + 2 * (src % 4) +
                                     code % 2) * LD;
                          y = s_k + (r0 + src / 4 + 8 * (code % 4 / 2)) * LD;
                        });
      // w (in s) and dr (in dw) of each pair
      const bool cap = a.softcap > 0.0f;
      if (!cap)
        tc::mask_cols(s, cls, a.kind, a.window, wj, i0, g, c2, a.Sq, a.Sk,
                      kRefused);
      const uint32_t refused =
          !cap || cls == tc::kFull ? 0u
              : tc::refused_bits<kNQ>(a.kind, a.window, i0 + c2, wj + g,
                                      a.Sq, a.Sk, false);
      auto pairs = [&](auto kcap) {
        constexpr bool kCap = decltype(kcap)::value;
#pragma unroll
        for (int nq = 0; nq < kNQ; ++nq)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ci = 8 * nq + c2 + e % 2;
            const bool ok = !kCap || !((refused >> (4 * nq + e)) & 1u);
            float y, dr;
            pair_grad<kCap, true>(
                a, s[nq][e], dw[nq][e], ok, t_st[ci], t_st[kBQT + ci],
                t_st[3 * kBQT + ci], t_st[2 * kBQT + ci], y, dr);
            s[nq][e] = y;
            dw[nq][e] = dr;
          }
      };
      if (cap)
        pairs(std::true_type());
      else
        pairs(std::false_type());
      // dv += w^T dO and dk += dr^T q, w and dr packed from the C
      // fragments (w rounded to bf16 by the packing)
#pragma unroll
      for (int kq = 0; kq < kBQT / 16; ++kq) {
        const uint32_t pw[4] = {
            tc::pack(s[2 * kq][0], s[2 * kq][1]),
            tc::pack(s[2 * kq][2], s[2 * kq][3]),
            tc::pack(s[2 * kq + 1][0], s[2 * kq + 1][1]),
            tc::pack(s[2 * kq + 1][2], s[2 * kq + 1][3])};
        const uint32_t pr[4] = {
            tc::pack(dw[2 * kq][0], dw[2 * kq][1]),
            tc::pack(dw[2 * kq][2], dw[2 * kq][3]),
            tc::pack(dw[2 * kq + 1][0], dw[2 * kq + 1][1]),
            tc::pack(dw[2 * kq + 1][2], dw[2 * kq + 1][3])};
#pragma unroll
        for (int nd = 0; nd < kND; nd += 2) {
          uint32_t bb[4];
          tc::load_b_cols(bb, t_do, LD, 16 * kq, 8 * nd, lane);
          tc::mma(dv[nd], pw, bb[0], bb[1]);
          tc::mma(dv[nd + 1], pw, bb[2], bb[3]);
          tc::load_b_cols(bb, t_q, LD, 16 * kq, 8 * nd, lane);
          tc::mma(dk[nd], pr, bb[0], bb[1]);
          tc::mma(dk[nd + 1], pr, bb[2], bb[3]);
        }
      }
    }
    if (u + 1 < n) {
      tc::cp_async_wait<0>();        // this thread's copies of tile u + 1
      side((u + 1) % 2);
    }
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = wj + g + 8 * r;
    if (j >= a.Sk) continue;
    bf16* dkrow = static_cast<bf16*>(a.dk) + b * a.sdk.b + j * a.sdk.s +
                  kvh * a.sdk.h;
    bf16* dvrow = static_cast<bf16*>(a.dv) + b * a.sdv.b + j * a.sdv.s +
                  kvh * a.sdv.h;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int d = 8 * nd + c2 + t;
        if (d < a.hd) {
          dkrow[d] = __float2bfloat16_rn(dk[nd][2 * r + t]);
          dvrow[d] = __float2bfloat16_rn(dv[nd][2 * r + t]);
        }
      }
  }
}

template <int HD>
int launch_bf16(const Args& a, int B, int K, cudaStream_t stream) {
  using Cfg = Bf16Bwd<HD>;
  static bool configured = false;   // once per instantiation and process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        dq_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Cfg::dq_bytes());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        dkv_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Cfg::dkv_bytes());
    if (err != cudaSuccess) return err;
    configured = true;
  }
  dq_bf16_kernel<HD><<<dim3((a.Sq + Cfg::kBQ - 1) / Cfg::kBQ, a.H, B),
                       kTcThreads, Cfg::dq_bytes(), stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkv_bf16_kernel<HD><<<dim3((a.Sk + Cfg::kBKV - 1) / Cfg::kBKV, K, B),
                        kTcThreads, Cfg::dkv_bytes(), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Strides are (batch, seq, head) in
// elements for q, k, v, dO, dq, dk, dv (21 values) in the (B, S, heads,
// hd) layout with a unit head-dim stride.  m, l: the forward's row max
// and sum of exponentials, (B, H, Sq) float32; D: scratch of the same
// shape.  kind: 0 causal, 1 window, 2 chunk, 3 bidir (or cross).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* m, const float* l, float* D, void* dq, void* dk, void* dv,
    const long long* strides, int B, int H, int K, int Sq, int Sk, int hd,
    int dtype, int kind, int window, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || Sq < 1 || Sk < 1 || hd < 1 ||
      hd > 128 || kind < 0 || kind > 3)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.m = m; a.l = l; a.D = D;
  a.dq = dq; a.dk = dk; a.dv = dv;
  Strides* st[7] = {&a.sq, &a.sk, &a.sv, &a.sdo, &a.sdq, &a.sdk, &a.sdv};
  for (int t = 0; t < 7; ++t)
    *st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  a.H = H; a.G = H / K; a.Sq = Sq; a.Sk = Sk; a.hd = hd;
  a.kind = kind; a.window = window;
  a.sqrt_hd = sqrtf((float)hd); a.softcap = softcap;
  a.r_sqrt_hd = 1.0f / a.sqrt_hd;
  a.r_softcap = softcap > 0.0f ? 1.0f / softcap : 0.0f;
  a.vec = false;
  if (dtype == 0) {
    if (hd <= 64) return launch<float, 64>(a, B, K, s);
    return launch<float, 128>(a, B, K, s);
  }
  if (dtype == 1) {
    a.vec = repro_tc::vec_ok(q, a.sq.b, a.sq.s, a.sq.h, hd) &&
            repro_tc::vec_ok(k, a.sk.b, a.sk.s, a.sk.h, hd) &&
            repro_tc::vec_ok(v, a.sv.b, a.sv.s, a.sv.h, hd) &&
            repro_tc::vec_ok(dout, a.sdo.b, a.sdo.s, a.sdo.h, hd);
    if (hd <= 64) return launch_bf16<64>(a, B, K, s);
    return launch_bf16<128>(a, B, K, s);
  }
  return cudaErrorInvalidValue;
}
