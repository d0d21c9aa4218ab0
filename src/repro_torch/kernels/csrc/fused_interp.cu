// Fused surrogate refit (distance + recency-weighted IDW/RBF reduction), for
// Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/surrogate_distance.py
// (`fused_interp`, body `_fused_interp_kernel`).  Per query q against M
// measurements m_j with objectives y_j and recency weights w_j:
//   d2_j   = max(|q|^2 + |m_j|^2 - 2 q.m_j, 0)      (the expansion form)
//   k_j    = w_j / (d2_j^(p/2) + eps)               (IDW)
//          | w_j * exp(-d2_j / (2 l^2))             (RBF)
//   mean   = sum k_j y_j / sum k_j, or the w-weighted global mean of y
//            when sum k_j <= 1e-12
//   dmin   = sqrt(min_j d2_j)
// The (Q, M) distance matrix is never written to device memory.
//
// Bound on this card: operations.  Each (query, measurement) pair costs a
// 2F-operation dot product plus about ten more; at the surrogate's chunk
// (Q = 8,192, M = 1,024, F = 16) that is about 0.35 GFLOP of float32
// outside the tensor cores, some 5 us at 67 TFLOP/s, against 0.6 MB of
// input and output (0.2 us at 3.35 TB/s).
//
// Design: a block owns 32 queries (one per lane) and splits the measurement
// axis over its 8 warps.  Each thread keeps its query's features, |q|^2 and
// its running weight sum, weighted sum, min d2 and the fallback's sums in
// registers.  Measurement rows stream through shared memory in tiles of up
// to 512 rows, so M has no upper limit; all lanes of a warp read the same
// row (a broadcast).  The tile loader computes |m|^2 once per row.  The
// fallback's global sums sum(y w) and sum(w) are recomputed by every block
// in the same stream (two operations per pair, no pre-pass).  At the end
// the 8 warps' partials are combined through shared memory.  |q|^2, |m|^2
// and q.m all run the same fmaf chain over the features, so a query that
// equals a measurement gets d2 == 0 exactly: dmin 0 and the IDW weight
// w / eps, whatever the rounding of the dot product.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQB = 32;      // queries per block: one per lane
constexpr int kSplit = 8;    // warps per block, each a slice of the rows
constexpr int kThreads = kQB * kSplit;

template <int FMAX>
__global__ void __launch_bounds__(kThreads)
fused_interp_kernel(const float* __restrict__ xq,
                    const float* __restrict__ xm,
                    const float* __restrict__ y,
                    const float* __restrict__ w,
                    float* __restrict__ mean_out,
                    float* __restrict__ dmin_out,
                    int Q, int M, int F, int rbf, float idw_half, float eps,
                    float rbf_den) {
  constexpr int TM = (8192 / FMAX) < 512 ? (8192 / FMAX) : 512;
  __shared__ float s_m[TM * FMAX];
  __shared__ float s_mm[TM];
  __shared__ float s_y[TM];
  __shared__ float s_w[TM];
  __shared__ float s_red[5][kSplit][kQB];

  const int lane = threadIdx.x;
  const int split = threadIdx.y;
  const int tid = split * kQB + lane;
  const int q = blockIdx.x * kQB + lane;
  const bool live = q < Q;

  float qf[FMAX];
#pragma unroll
  for (int f = 0; f < FMAX; ++f) {
    qf[f] = (live && f < F) ? xq[static_cast<int64_t>(q) * F + f] : 0.0f;
  }
  float qq = 0.0f;
#pragma unroll
  for (int f = 0; f < FMAX; ++f) qq = fmaf(qf[f], qf[f], qq);

  float wsum = 0.0f, ky = 0.0f, d2min = INFINITY, yw = 0.0f, wtot = 0.0f;
  for (int base = 0; base < M; base += TM) {
    const int rows = min(TM, M - base);
    __syncthreads();                       // previous tile fully consumed
    for (int e = tid; e < TM * FMAX; e += kThreads) {
      const int j = e / FMAX;
      const int f = e % FMAX;
      s_m[e] = (j < rows && f < F)
                   ? xm[static_cast<int64_t>(base + j) * F + f]
                   : 0.0f;
    }
    for (int j = tid; j < rows; j += kThreads) {
      s_y[j] = y[base + j];
      s_w[j] = w[base + j];
    }
    __syncthreads();
    for (int j = tid; j < rows; j += kThreads) {
      float mm = 0.0f;
#pragma unroll
      for (int f = 0; f < FMAX; ++f) {
        mm = fmaf(s_m[j * FMAX + f], s_m[j * FMAX + f], mm);
      }
      s_mm[j] = mm;
    }
    __syncthreads();
    if (live) {
      for (int j = split; j < rows; j += kSplit) {
        const float* m = &s_m[j * FMAX];
        float g = 0.0f;
#pragma unroll
        for (int f = 0; f < FMAX; ++f) g = fmaf(qf[f], m[f], g);
        const float d2 = fmaxf((qq + s_mm[j]) - 2.0f * g, 0.0f);
        float k;
        if (rbf) {
          k = expf(-d2 / rbf_den);
        } else {
          const float dp = idw_half == 1.0f ? d2 : powf(d2, idw_half);
          k = 1.0f / (dp + eps);
        }
        const float wj = s_w[j];
        const float yj = s_y[j];
        k = k * wj;
        wsum += k;
        ky += k * yj;
        d2min = fminf(d2min, d2);
        yw += yj * wj;
        wtot += wj;
      }
    }
  }

  s_red[0][split][lane] = wsum;
  s_red[1][split][lane] = ky;
  s_red[2][split][lane] = d2min;
  s_red[3][split][lane] = yw;
  s_red[4][split][lane] = wtot;
  __syncthreads();
  if (split == 0 && live) {
    float W = 0.0f, KY = 0.0f, D = INFINITY, YW = 0.0f, WT = 0.0f;
#pragma unroll
    for (int s = 0; s < kSplit; ++s) {
      W += s_red[0][s][lane];
      KY += s_red[1][s][lane];
      D = fminf(D, s_red[2][s][lane]);
      YW += s_red[3][s][lane];
      WT += s_red[4][s][lane];
    }
    const float fallback = YW / fmaxf(WT, 1e-12f);
    mean_out[q] = W > 1e-12f ? KY / fmaxf(W, 1e-12f) : fallback;
    dmin_out[q] = sqrtf(D);
  }
}

template <int FMAX>
cudaError_t launch(const void* xq, const void* xm, const void* y,
                   const void* w, void* mean, void* dmin, int Q, int M,
                   int F, int rbf, float idw_half, float eps, float rbf_den,
                   cudaStream_t stream) {
  const dim3 block(kQB, kSplit);
  const int blocks = (Q + kQB - 1) / kQB;
  fused_interp_kernel<FMAX><<<blocks, block, 0, stream>>>(
      static_cast<const float*>(xq), static_cast<const float*>(xm),
      static_cast<const float*>(y), static_cast<const float*>(w),
      static_cast<float*>(mean), static_cast<float*>(dmin), Q, M, F, rbf,
      idw_half, eps, rbf_den);
  return cudaGetLastError();
}

}  // namespace

// xq: (Q, F), xm: (M, F), y/w: (M,) float32, row-major; mean/dmin: (Q,)
// float32 outputs, all on the current CUDA device.  Q >= 1, M >= 1,
// 1 <= F <= 256.  rbf != 0 selects the Gaussian weight exp(-d2 / rbf_den);
// otherwise IDW 1 / (d2^idw_half + eps).  Launches on `stream` and returns
// the launch's cudaError_t (0 on success).
extern "C" int fused_interp_launch(const void* xq, const void* xm,
                                   const void* y, const void* w, void* mean,
                                   void* dmin, int Q, int M, int F, int rbf,
                                   float idw_half, float eps, float rbf_den,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || M < 1 || F < 1) return cudaErrorInvalidValue;
#define REPRO_FI_CASE(FM)                                                 \
  if (F <= FM)                                                            \
    return launch<FM>(xq, xm, y, w, mean, dmin, Q, M, F, rbf, idw_half,   \
                      eps, rbf_den, s);
  REPRO_FI_CASE(8)
  REPRO_FI_CASE(16)
  REPRO_FI_CASE(32)
  REPRO_FI_CASE(64)
  REPRO_FI_CASE(128)
  REPRO_FI_CASE(256)
#undef REPRO_FI_CASE
  return cudaErrorInvalidValue;
}
