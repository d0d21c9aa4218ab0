// Pairwise squared Euclidean distances by the expansion, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/surrogate_distance.py
// (`pairwise_sqdist`, body `_sqdist_kernel`): for xq (Q, F) and xm (M, F)
// float32,
//   d2[i][j] = max(||q_i||^2 + ||m_j||^2 - 2 q_i . m_j, 0)
// as (Q, M) float32, each sum in float32.  The TPU wrapper pads Q and M to
// its tiles (padded rows at a far sentinel) and F to the 128-lane width,
// then slices back; here the tiles' ragged edges are masked in the kernel
// and nothing is padded in device memory.
//
// Bound on this card: bytes.  The (Q, M) result is written once: at the
// surrogate's grid chunk (Q 8,192 grid states against M 1,024 probes, F
// features) that is 33.6 MB, 0.010 ms at 3.35 TB/s, against 2 F Q M
// operations of products (0.004 ms at 67 TFLOP/s float32 for F 16).
//
// Design: a block of 16 x 16 threads owns a 64 x 64 tile of the result;
// thread (ty, tx) owns rows ty + 16 a and columns tx + 16 c (a, c < 4), so
// each of its 16 stores is part of a warp's run of 16 consecutive floats.
// The block stages the tile's 64 query rows and 64 measurement rows in
// shared memory, kF features at a time (rows padded by one word so the
// column reads fall on distinct banks), and every thread accumulates its
// 16 dot products and its rows' and columns' squared norms from there.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kDim = 16;               // threads per tile side
constexpr int kPer = kTile / kDim;     // rows (columns) per thread
constexpr int kF = 32;                 // features staged at once

__global__ void __launch_bounds__(kDim * kDim)
pairwise_sqdist_kernel(const float* __restrict__ xq,
                       const float* __restrict__ xm, float* __restrict__ d2,
                       int Q, int M, int F) {
  __shared__ float s_q[kTile][kF + 1];
  __shared__ float s_m[kTile][kF + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kDim + tx;
  const int q0 = blockIdx.y * kTile, m0 = blockIdx.x * kTile;

  float dot[kPer][kPer], qq[kPer], mm[kPer];
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    qq[a] = mm[a] = 0.0f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) dot[a][c] = 0.0f;
  }
  for (int f0 = 0; f0 < F; f0 += kF) {
    __syncthreads();   // the previous features are consumed
    for (int e = tid; e < kTile * kF; e += kDim * kDim) {
      const int row = e / kF, f = f0 + e % kF;
      const bool fin = f < F;
      s_q[row][e % kF] = (fin && q0 + row < Q)
          ? xq[static_cast<long long>(q0 + row) * F + f] : 0.0f;
      s_m[row][e % kF] = (fin && m0 + row < M)
          ? xm[static_cast<long long>(m0 + row) * F + f] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < kF; ++f) {
      float qv[kPer], mv[kPer];
#pragma unroll
      for (int a = 0; a < kPer; ++a) {
        qv[a] = s_q[ty + kDim * a][f];
        mv[a] = s_m[tx + kDim * a][f];
        qq[a] = fmaf(qv[a], qv[a], qq[a]);
        mm[a] = fmaf(mv[a], mv[a], mm[a]);
      }
#pragma unroll
      for (int a = 0; a < kPer; ++a)
#pragma unroll
        for (int c = 0; c < kPer; ++c)
          dot[a][c] = fmaf(qv[a], mv[c], dot[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < kPer; ++a) {
    const int i = q0 + ty + kDim * a;
    if (i >= Q) continue;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      const int j = m0 + tx + kDim * c;
      if (j < M)
        d2[static_cast<long long>(i) * M + j] =
            fmaxf(qq[a] + mm[c] - 2.0f * dot[a][c], 0.0f);
    }
  }
}

}  // namespace

// xq (Q, F), xm (M, F), d2 (Q, M): float32, contiguous.
extern "C" int pairwise_sqdist_launch(const float* xq, const float* xm,
                                      float* d2, int Q, int M, int F,
                                      void* stream) {
  if (Q < 1 || M < 1 || F < 1) return cudaErrorInvalidValue;
  dim3 grid((M + kTile - 1) / kTile, (Q + kTile - 1) / kTile);
  pairwise_sqdist_kernel<<<grid, dim3(kDim, kDim), 0,
                           static_cast<cudaStream_t>(stream)>>>(
      xq, xm, d2, Q, M, F);
  return cudaGetLastError();
}
