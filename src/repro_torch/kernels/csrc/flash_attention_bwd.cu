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
//           of exponentials l_i (so y is the forward's softmax bit for bit)
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
// is the same in exact arithmetic but not at these roundings.
//
// Bound on this card: five products of the S x S score shape (q.k again,
// dO.v, w^T dO, dr k, dr^T q).  At qwen3-8b's training head layout (B 1,
// S 4096, H 32, K 8, hd 128, causal) that is about 344 GFLOP, 0.35 ms at
// the tensor cores' 989 TFLOP/s bf16; the bytes (q, k, v, dO read, dq,
// dk, dv written, ~80 MB) take 0.024 ms.  This first version computes
// with float32 FMAs from shared memory and does nine products, not five
// (the dq pass takes q.k and dO.v twice, once for D and once for ds, and
// the dk/dv pass takes them again), so it is bounded by the shared-memory
// reads of its inner products; the tensor cores are a later change.
//
// Design, deterministic (no atomics): two kernels on one stream.
//   1. dq pass, one block per (query block of 64, head, batch row), as the
//      forward's layout (4 threads per query row, 8 of a 32-key tile's
//      scores each): sweep 1 over the row's keys accumulates D_i (written
//      to a float32 scratch (B, H, Sq) for pass 2), sweep 2 recomputes y
//      and dw, forms dr in shared memory, and accumulates dq.
//   2. dk/dv pass, one block per (key block of 64, kv head, batch row):
//      k and v of the block stay in shared memory; the block walks the G
//      query heads and, for each, every tile of 32 queries that can see
//      its keys (causal, window and chunk stop where the mask does), and
//      4 threads per key accumulate dk and dv in registers.
// Inputs are read through their strides in the model's (B, S, heads, hd)
// layout (unit stride in the head dim).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerRow = 4;           // threads per query row (dq) or key (dkv)
constexpr int kBQ = 64;              // dq pass: query rows per block
constexpr int kBK = 32;              // dq pass: keys per tile
constexpr int kBKV = 64;             // dkv pass: keys per block
constexpr int kBQT = 32;             // dkv pass: queries per tile
constexpr int kCols = 32 / kPerRow;  // products per thread per tile
constexpr float kNegInf = -0.7f * FLT_MAX;

enum Kind { kCausal = 0, kWindow = 1, kChunk = 2, kBidir = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

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
};

__device__ __forceinline__ bool allowed(int kind, int window, int i, int j) {
  if (kind == kBidir) return true;
  bool m = j <= i;
  if (kind == kWindow && window > 0) m = m && (j > i - window);
  if (kind == kChunk && window > 0) m = m && (i / window == j / window);
  return m;
}

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
#define REPRO_FAB_CASE(TYPE, HDM) return launch<TYPE, HDM>(a, B, K, s);
  if (dtype == 0) {
    if (hd <= 64) REPRO_FAB_CASE(float, 64)
    REPRO_FAB_CASE(float, 128)
  }
  if (dtype == 1) {
    if (hd <= 64) REPRO_FAB_CASE(__nv_bfloat16, 64)
    REPRO_FAB_CASE(__nv_bfloat16, 128)
  }
#undef REPRO_FAB_CASE
  return cudaErrorInvalidValue;
}
