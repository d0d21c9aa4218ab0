// RWKV-6 wkv recurrence, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_wkv.py (`wkv6`,
// body `_wkv_kernel`).  Per batch row b and head h, with the state S
// (hd_k x hd_v) starting at the given initial state (or 0):
//   o_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] = exp(logw_t[i]) S[i][j] + k_t[i] v_t[j]
// for t = 0 .. S-1, in float32 from r, k, v (bf16 or float32) and logw
// (float32); it writes o (B, S, H, hd) float32 and the final state
// (B, H, hd, hd) float32, which the TPU kernel keeps in VMEM scratch and
// the serve path's prefill hands to the decode steps.  This is the
// reference package's sequential recurrence (`ref.wkv6_ref`); the TPU
// kernel and the model (`models/rwkv6.py` `wkv6_chunked`) compute the same
// sums in a chunked order, so the two agree to float32 rounding (the JAX
// tests' atol 5e-4, rtol 1e-3).
//
// Bound on this card: bytes.  At rwkv6-7b's prefill (B 16, S 512, H 64,
// hd 64) it reads r, k, v in bf16 (201 MB) and logw in float32 (134 MB),
// writes o (134 MB) and the state (17 MB): 486 MB, 0.145 ms at 3.35 TB/s.
// The recurrence as written is 4 multiply-adds per state element and step,
// 8.6 GFLOP counted as 4 operations each, 0.128 ms at 67 TFLOP/s float32.
//
// Design.  The recurrence is sequential in t, so a block owns one (b, h)
// and walks the steps; what limits it is the instructions a step takes
// per state element, not the bytes.  The bonus term leaves the inner loop:
//   o_t[j] = sum_i r_t[i] S[i][j] + v_t[j] * (sum_i r_t[i] u[i] k_t[i]),
// the second factor one dot product per (b, h, t), taken by a warp's
// shuffles while the step is staged, so a state element costs three
// float32 instructions a step (acc = fma(r, S, acc); kv = k * v;
// S = fma(w, S, kv)) instead of four.  A thread holds an I x 8 tile of the
// state in registers (I = 8 rows i, 4 at hd 32, in runs of 4 consecutive
// i; 8 consecutive columns j), so a run's three 16-byte shared loads of
// r, k and exp(logw) feed 96 float32 instructions: the previous kernel,
// one column a thread, issued four scalar shared loads for every four,
// and its time was the shared-load issue rate's; this one's follows its
// float32 instruction count (PERF.md, findings).  The P =
// hd / I threads of a column group are neighbouring lanes: a quarter warp
// reads 8 neighbouring 16-byte runs of i (one wavefront) and one run of v
// (a broadcast), and the P partial outputs of the 8 columns meet in a
// reduce-scatter over the P lanes (7 shuffles for 8 sums), after which
// each lane holds one column's output.  A block has hd * hd / (8 I)
// threads (64 at hd 64).  The block stages 1024 / hd steps of r, k, v and
// exp(logw) at a time in shared memory (float32, read through the inputs'
// strides in the model's (B, S, H, hd) layout, with no transposed copy),
// 16 KB, so that every (b, h) of rwkv6-7b's prefill is resident at once.
// The state sums run in another order than the previous kernel's, inside
// the same tolerance.  The chunked form's (L, L) products would suit the
// tensor cores, but its exp(+-cum) factors need about float32 precision;
// folding two steps into one update saves float32 work but needs more
// registers than it saves time (PERF.md, open questions).
//
// ptxas (sm_90a, CUDA 12.8): 109-128 registers (hd 64: 126, 64 threads a
// block), no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "warp_tree.cuh"

namespace {

struct Strides {
  long long b, s, h;   // elements; the head dim has stride 1
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

constexpr int kCols = 8;               // state columns j a thread holds

template <int HD>
struct Shape {
  static constexpr int kI = HD == 32 ? 4 : 8;      // state rows i a thread
  static constexpr int kP = HD / kI;               // threads a column group
  static constexpr int kThreads = HD / kCols * kP;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kT = 1024 / HD;             // steps staged at once
  static constexpr int kEPS = HD / 32;             // staged elements a lane
  static_assert(kP == 8 || kP == 16, "8 or 16 threads a column group");
  static constexpr int kShift = kP == 16 ? 1 : 0;  // log2(kP / kCols)
};

template <typename T, int HD>
__global__ void __launch_bounds__(Shape<HD>::kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_out, Strides sr,
            Strides sk, Strides sv, Strides sw, int S, int H) {
  using Sh = Shape<HD>;
  constexpr int P = Sh::kP, kT = Sh::kT, EPS = Sh::kEPS;
  constexpr int M = Sh::kI / 4;                    // runs of 4 rows
  constexpr int kShift = Sh::kShift;
  __shared__ __align__(16) float s_r[kT][HD];
  __shared__ __align__(16) float s_k[kT][HD];
  __shared__ __align__(16) float s_w[kT][HD];
  __shared__ __align__(16) float s_v[kT][HD];
  __shared__ float s_b[kT];                         // sum_i r u k per step

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int lane = threadIdx.x % 32;
  const int p = threadIdx.x % P;                    // part of i
  const int j0 = threadIdx.x / P * kCols;           // first column
  // row i = 4 * (p + P * m) + e of the thread's state, e < 4, m < M; after
  // the reduce-scatter the thread holds column j0 + (p >> kShift)
  const int jo = j0 + (p >> kShift);
  const bool lead = (p & ((1 << kShift) - 1)) == 0;

  const long long sbase = static_cast<long long>(blockIdx.x) * HD * HD;
  float st[M][4][kCols];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (p + P * m) + e;
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (s0 != nullptr)
          x = *reinterpret_cast<const float4*>(s0 + sbase + i * HD + j0 + c);
        st[m][e][c] = x.x; st[m][e][c + 1] = x.y; st[m][e][c + 2] = x.z;
        st[m][e][c + 3] = x.w;
      }
    }

  // staging: warp w takes steps w, w + kWarps, ...; lane the EPS elements
  // from lane * EPS; it also sums r u k for the step
  const int warp = threadIdx.x / 32;
  const int d0 = lane * EPS;
  float uu[EPS];
#pragma unroll
  for (int e = 0; e < EPS; ++e) uu[e] = u[h * HD + d0 + e];
  const T* rb = r + b * sr.b + h * sr.h + d0;
  const T* kb = k + b * sk.b + h * sk.h + d0;
  const T* vb = v + b * sv.b + h * sv.h + d0;
  const float* wb = logw + b * sw.b + h * sw.h + d0;
  float* ob = o + (static_cast<long long>(b) * S * H + h) * HD + jo;
  const long long o_step = static_cast<long long>(H) * HD;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    __syncthreads();   // the previous steps are consumed
    for (int tt = warp; tt < n; tt += Sh::kWarps) {
      const long long t = t0 + tt;
      float bonus = 0.0f;
#pragma unroll
      for (int e = 0; e < EPS; ++e) {
        const float rx = to_f(rb[t * sr.s + e]);
        const float kx = to_f(kb[t * sk.s + e]);
        s_r[tt][d0 + e] = rx;
        s_k[tt][d0 + e] = kx;
        s_v[tt][d0 + e] = to_f(vb[t * sv.s + e]);
        s_w[tt][d0 + e] = expf(wb[t * sw.s + e]);
        bonus = fmaf(rx * uu[e], kx, bonus);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        bonus += __shfl_xor_sync(0xffffffffu, bonus, off);
      if (lane == 0) s_b[tt] = bonus;
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(&s_v[tt][j0 + c]);
        vj[c] = x.x; vj[c + 1] = x.y; vj[c + 2] = x.z; vj[c + 3] = x.w;
      }
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int c4 = 4 * (p + P * m);
        const float4 r4 = *reinterpret_cast<const float4*>(&s_r[tt][c4]);
        const float4 k4 = *reinterpret_cast<const float4*>(&s_k[tt][c4]);
        const float4 w4 = *reinterpret_cast<const float4*>(&s_w[tt][c4]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc[c] = fmaf(rr[e], st[m][e][c], acc[c]);
            st[m][e][c] = fmaf(ww[e], st[m][e][c], kk[e] * vj[c]);
          }
      }
      const float x = repro_warp::tree_scatter<kCols, P / 2>(acc, lane);
      if (lead)
        ob[(t0 + tt) * o_step] = fmaf(s_v[tt][jo], s_b[tt], x);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (p + P * m) + e;
#pragma unroll
      for (int c = 0; c < kCols; c += 4)
        *reinterpret_cast<float4*>(s_out + sbase + i * HD + j0 + c) =
            make_float4(st[m][e][c], st[m][e][c + 1], st[m][e][c + 2],
                        st[m][e][c + 3]);
    }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* o, float* s_out,
           const Strides* st, int B, int S, int H, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<B * H, Shape<HD>::kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, s0, o, s_out, st[0], st[1], st[2],
      st[3], S, H);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* logw,
             const float* u, const float* s0, float* o, float* s_out,
             const Strides* st, int B, int S, int H, int hd,
             cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(r, k, v, logw, u, s0, o, s_out, st, B, S, H,
                           stream);
    case 64:
      return launch<T, 64>(r, k, v, logw, u, s0, o, s_out, st, B, S, H,
                           stream);
    case 128:
      return launch<T, 128>(r, k, v, logw, u, s0, o, s_out, st, B, S, H,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, v (B, S, H, hd) of one type (dtype 0 float32, 1 bfloat16) and
// logw (B, S, H, hd) float32, each with the (batch, seq, head) strides in
// `strides` (elements; unit head-dim stride); u (H, hd) float32; s0 null
// or (B, H, hd, hd) float32; o (B, S, H, hd) and s_out (B, H, hd, hd)
// float32, contiguous.  hd is 32, 64 or 128.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const float* logw, const float* u,
                           const float* s0, float* o, float* s_out,
                           const long long* strides, int B, int S, int H,
                           int hd, int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1) return cudaErrorInvalidValue;
  Strides st[4];
  for (int t = 0; t < 4; ++t)
    st[t] = Strides{strides[3 * t], strides[3 * t + 1], strides[3 * t + 2]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(r, k, v, logw, u, s0, o, s_out, st, B, S, H, hd,
                           s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(r, k, v, logw, u, s0, o, s_out, st, B, S,
                                   H, hd, s);
  return cudaErrorInvalidValue;
}
