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
// reference package's sequential oracle (`ref.wkv6_ref`); the TPU kernel
// and the model (`models/rwkv6.py` `wkv6_chunked`) compute the same sums in
// a chunked order, so the two agree to float32 rounding (the JAX tests'
// atol 5e-4, rtol 1e-3).
//
// Bound on this card: bytes.  At rwkv6-7b's prefill (B 16, S 512, H 64,
// hd 64) it reads r, k, v in bf16 (201 MB) and logw in float32 (134 MB),
// writes o (134 MB) and the state (17 MB): 486 MB, 0.145 ms at 3.35 TB/s.
// The recurrence is 4 multiply-adds per state element and step, 8.6
// GFLOP counted as 4 operations each, 0.128 ms at 67 TFLOP/s float32.
//
// Design: one block of hd threads per (b, h); thread j owns column j of
// the state and keeps it in hd registers for the whole sequence (16 KB of
// state per block at hd 64, as the TPU kernel's scratch tile).  The TPU
// kernel's sequential chunk axis becomes the loop over time inside the
// block: the block stages kT time steps of r, k, v and exp(logw) (one
// element per thread per row, coalesced along the head dim, read through
// the inputs' strides in the model's (B, S, H, hd) layout with no
// transposed copy) in shared memory, then each thread walks them step by
// step, reading r, k, exp(logw) and u as shared-memory broadcasts.  The
// output sum of a step runs in four partial sums, so its adds overlap.
// The chunked form's (L, L) products would suit the tensor cores; that is
// a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Strides {
  long long b, s, h;   // elements; the head dim has stride 1
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_out, Strides sr,
            Strides sk, Strides sv, Strides sw, int S, int H) {
  constexpr int kT = 1024 / HD;          // time steps staged at once
  __shared__ float s_r[kT][HD], s_k[kT][HD], s_v[kT][HD], s_w[kT][HD];
  __shared__ float s_u[HD];

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int j = threadIdx.x;
  s_u[j] = u[h * HD + j];

  const long long sbase = static_cast<long long>(blockIdx.x) * HD * HD;
  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i)
    st[i] = s0 != nullptr ? s0[sbase + i * HD + j] : 0.0f;

  const T* rb = r + b * sr.b + h * sr.h + j;
  const T* kb = k + b * sk.b + h * sk.h + j;
  const T* vb = v + b * sv.b + h * sv.h + j;
  const float* wb = logw + b * sw.b + h * sw.h + j;
  float* ob = o + (static_cast<long long>(b) * S * H + h) * HD + j;
  const long long o_step = static_cast<long long>(H) * HD;

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int n = min(kT, S - t0);
    __syncthreads();   // the previous steps are consumed (s_u is written)
    for (int tt = 0; tt < n; ++tt) {
      const long long t = t0 + tt;
      s_r[tt][j] = to_f(rb[t * sr.s]);
      s_k[tt][j] = to_f(kb[t * sk.s]);
      s_v[tt][j] = to_f(vb[t * sv.s]);
      s_w[tt][j] = expf(wb[t * sw.s]);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = s_v[tt][j];
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        const float kv = s_k[tt][i] * vj;
        acc[i % 4] = fmaf(s_r[tt][i], fmaf(s_u[i], kv, st[i]), acc[i % 4]);
        st[i] = fmaf(s_w[tt][i], st[i], kv);
      }
      ob[(t0 + tt) * o_step] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[sbase + i * HD + j] = st[i];
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* logw,
           const float* u, const float* s0, float* o, float* s_out,
           const Strides* st, int B, int S, int H, cudaStream_t stream) {
  wkv6_kernel<T, HD><<<B * H, HD, 0, stream>>>(
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
