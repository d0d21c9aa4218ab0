// Row-wise int8 quantization (gradient compression), for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/quantize.py
// (`quantize_int8`, body `_quant_kernel`).  For each row r of x (M, N):
//   scale_r = max(max_j |x_rj|, 1e-12) / 127            (IEEE division)
//   q_rj    = clip(round_half_even(x_rj / scale_r), -127, 127) as int8
// the arithmetic of the reference's jnp `optim/compression.py`
// `quantize_int8` (`jnp.round` rounds half to even, as `rintf` does in the
// default rounding mode), so the payload is bit-equal to it and to the
// plain version.  Input float32 or bfloat16 (upcast to float32 first).
// A NaN in a row is not propagated to its scale (fmaxf drops it).
//
// Bound on this card: the kernel must read x once (4 bytes an element for
// float32) and write q (1 byte) and the scales: at the largest gradient of
// repro-100m, 32,768 x 768 float32, about 126 MB, 0.038 ms at 3.35 TB/s.
// There is no arithmetic to speak of (a compare, a division and a round
// an element), so it is bounded by bytes.
//
// Design: the TPU kernel holds a (256, N) tile in VMEM and reads x once.
// Here a row is reduced by one warp when it is short (N <= 4096: eight
// rows a block, no shared memory) or by a whole block of 256 threads when
// it is long (the lm_head gradient's rows of 32,768), so any M and any N
// work and the grid fills the card either way.  The row is read twice,
// once for the absmax and once to quantize; the second read finds it in
// L1/L2 (a row is at most 128 KB, and a block's rows are contiguous).
// float32 rows whose length is a multiple of 4 are read 16 bytes and
// written 4 bytes a thread at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int8_t quant(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
}

// TPR threads own one row; VEC4: float32 rows read as float4
template <typename T, int TPR, bool VEC4>
__global__ void __launch_bounds__(kThreads)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, long long M, int N) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  __shared__ float s_red[kThreads / 32];
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const bool live = row < M;
  const T* xr = x + (live ? row : 0) * static_cast<long long>(N);
  int8_t* qr = q + (live ? row : 0) * static_cast<long long>(N);

  float amax = 0.0f;
  if (live) {
    if constexpr (VEC4) {
      const float4* x4 = reinterpret_cast<const float4*>(xr);
      for (int j = lane; j < N / 4; j += TPR) {
        const float4 v = x4[j];
        amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                                 fmaxf(fabsf(v.z), fabsf(v.w))));
      }
    } else {
      for (int j = lane; j < N; j += TPR)
        amax = fmaxf(amax, fabsf(to_f(xr[j])));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if constexpr (TPR > 32) {
    if (lane % 32 == 0) s_red[lane / 32] = amax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) amax = fmaxf(amax, s_red[w]);
  }
  if (!live) return;
  const float s = __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
  if constexpr (VEC4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    char4* q4 = reinterpret_cast<char4*>(qr);
    for (int j = lane; j < N / 4; j += TPR) {
      const float4 v = x4[j];
      q4[j] = make_char4(quant(v.x, s), quant(v.y, s), quant(v.z, s),
                         quant(v.w, s));
    }
  } else {
    for (int j = lane; j < N; j += TPR) qr[j] = quant(to_f(xr[j]), s);
  }
  if (lane == 0) scale[row] = s;
}

template <typename T, int TPR, bool VEC4>
int launch(const void* x, void* q, void* scale, long long M, int N,
           cudaStream_t stream) {
  constexpr int kRowsPerBlock = kThreads / TPR;
  const long long blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  quantize_int8_kernel<T, TPR, VEC4>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scale), M, N);
  return cudaGetLastError();
}

}  // namespace

// x (M, N) contiguous, float32 (dtype 0) or bfloat16 (dtype 1); q (M, N)
// int8 and scale (M,) float32, both contiguous.  vec4: x and q may be
// accessed 16 and 4 bytes at a time (float32, N % 4 == 0, aligned).
extern "C" int quantize_int8_launch(const void* x, void* q, void* scale,
                                    long long M, int N, int dtype, int vec4,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  const bool short_rows = N <= 4096;
  if (dtype == 0) {
    if (vec4) {
      return short_rows ? launch<float, 32, true>(x, q, scale, M, N, s)
                        : launch<float, kThreads, true>(x, q, scale, M, N, s);
    }
    return short_rows ? launch<float, 32, false>(x, q, scale, M, N, s)
                      : launch<float, kThreads, false>(x, q, scale, M, N, s);
  }
  return short_rows
             ? launch<__nv_bfloat16, 32, false>(x, q, scale, M, N, s)
             : launch<__nv_bfloat16, kThreads, false>(x, q, scale, M, N, s);
}
