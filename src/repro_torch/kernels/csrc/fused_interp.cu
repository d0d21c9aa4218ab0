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
// input and output (0.2 us at 3.35 TB/s).  The float32 pipe issues one
// instruction a lane and cycle, so the time follows the instructions a
// pair takes: 16 fmaf for the dot product, about 15 for the distance,
// the weight and the sums, 1.25 shared loads and the row's share of the
// loop (about 140 instructions a row of 4 pairs, counted from the source).
//
// Design.  A thread owns QT queries (QT = 64 / FMAX, at most 4, for FMAX
// <= 64: 4 at F <= 16), their features in registers, and a block of 16
// warps, one an SM, owns 32 QT queries (lane l holds queries l, l + 32,
// ...), staged once through shared memory.  The measurement axis is cut
// into n_split <= 8 splits, chosen at launch (`plan_split`: up to one
// block an SM where M gives each split 64 rows; 2 at the surrogate's chunk
// on the H100's 132 SMs), and a block takes one split.  Each warp takes
// its own contiguous share of the split's rows and streams them through
// two tiles of its own (32 rows at F <= 16) by 16-byte cp.async, the next tile's copies going out before this tile's pairs, so
// the loop waits on no block barrier.  A row is packed as its FMAX
// features (zeros past F) followed by |m|^2, y and w; |m|^2 is computed
// when the tile lands, a lane a row.  All lanes read the same row (a
// broadcast), and one read of it feeds the QT independent fmaf chains of
// the thread's queries.  The weight needs no division call: 1 / (d2 + eps)
// is `rcp_rn` (correctly rounded, as the plain version's IEEE division),
// the RBF exponent a Markstein quotient.  The fallback's global sums are
// taken only when a query needs them (sum k <= 1e-12), by the block that
// finishes it, over all M rows.  Partial sums meet in a fixed order, with
// no float atomics and no device-memory scratch: the warps through shared
// memory, then the splits of a query block, launched as one thread-block
// cluster, in the first block's shared memory after one cluster barrier;
// so two calls give the same bits.  For F > 64 (no path has such F) the
// query features are read from L1 per row instead, one query a thread.
//
// Exactly zero at a measured state: |q|^2, |m|^2 and q.m run the same fmaf
// chain over the features (from 0, in feature order, zeros past F), so a
// query equal to a measurement gets d2 == 0 exactly: dmin 0 and the IDW
// weight w / eps, whatever the rounding of the dot product.  Tensor cores
// (TF32 or 3xTF32) would break this, so the work stays on the float32 pipe.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "ieee_div.cuh"

namespace {

namespace cg = cooperative_groups;
using repro_async::cp_async16;
using repro_async::cp_async4;
using repro_async::cp_async_commit;
using repro_async::cp_async_wait;
using repro_div::div_rn;
using repro_div::rcp_rn;

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplit = 8;    // splits of a cluster (the portable size)

// the weight's kinds: IDW with power 2 (path B), IDW with another power, RBF
enum Kind { kIdw2 = 0, kIdwPow = 1, kRbf = 2 };

template <int FMAX>
struct Plan {
  static constexpr bool kResident = FMAX <= 64;   // query features in registers
  static constexpr int QT = !kResident ? 1 : 64 / FMAX < 4 ? 64 / FMAX : 4;
  static constexpr int QB = 32 * QT;               // queries a block
  static constexpr int LD = FMAX + 4;  // a row: features, |m|^2, y, w, spare
  // rows of a warp's tile
  static constexpr int WT = 512 / FMAX < 32 ? 512 / FMAX : 32;
  static constexpr int kQueryFloats = kResident ? QB * LD : 0;
  // dynamic shared memory: two tiles a warp, then the queries
  static constexpr int kSmemFloats = kWarps * 2 * WT * LD + kQueryFloats;
  static_assert(3 * kWarps * QB <= kSmemFloats, "partials fit the tiles");
};

template <int KIND>
__device__ __forceinline__ float weight(float d2, float idw_half, float eps,
                                        float rbf_den, float rbf_rcp) {
  if constexpr (KIND == kRbf) {
    // an exponent below -104 gives 0, as does the NaN of a quotient that
    // overflows (fmaxf returns its other operand)
    return expf(fmaxf(div_rn(-d2, rbf_den, rbf_rcp), -104.0f));
  } else if constexpr (KIND == kIdwPow) {
    return rcp_rn(powf(d2, idw_half) + eps);
  } else {
    return rcp_rn(d2 + eps);
  }
}

// `rows` rows of src (rows of F floats from `base`) into rows of LD floats
// at dst, by threads t0 of nt: the first FMAX floats by 16-byte cp.async
// (zero-filled past F and past the last row, up to `pad_rows`) when vec,
// else by plain loads; with y and w, those beside each row (at FMAX + 1,
// FMAX + 2) by 4-byte cp.async
template <int FMAX>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          const float* __restrict__ y,
                                          const float* __restrict__ w,
                                          int64_t base, int rows,
                                          int pad_rows, int F, bool vec,
                                          int t0, int nt) {
  constexpr int LD = Plan<FMAX>::LD;
  constexpr int kQuads = FMAX / 4;
  for (int e = t0; e < pad_rows * kQuads; e += nt) {
    const int j = e / kQuads;
    const int f = 4 * (e % kQuads);
    float* d = dst + j * LD + f;
    const bool in = j < rows && f < F;
    const float* s = src + (base + j) * F + f;
    if (vec) {
      cp_async16(d, in ? s : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = in && f + i < F ? s[i] : 0.0f;
    }
  }
  if (y != nullptr) {
    for (int j = t0; j < rows; j += nt) {
      cp_async4(dst + j * LD + FMAX + 1, y + base + j);
      cp_async4(dst + j * LD + FMAX + 2, w + base + j);
    }
  }
}

// sum of y w and of w over all M rows, in a fixed order, on every thread
__device__ float2 fallback_sums(const float* __restrict__ y,
                                const float* __restrict__ w, int M,
                                float2* red) {
  float yw = 0.0f, wt = 0.0f;
  for (int j = threadIdx.x; j < M; j += kThreads) {
    yw += y[j] * w[j];
    wt += w[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    yw += __shfl_xor_sync(0xffffffffu, yw, o);
    wt += __shfl_xor_sync(0xffffffffu, wt, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = make_float2(yw, wt);
  __syncthreads();
  float2 s = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    s.x += red[i].x;
    s.y += red[i].y;
  }
  return s;
}

template <int FMAX, int KIND>
__global__ void __launch_bounds__(kThreads, 1)
fused_interp_kernel(const float* __restrict__ xq,
                    const float* __restrict__ xm,
                    const float* __restrict__ y,
                    const float* __restrict__ w,
                    float* __restrict__ mean_out,
                    float* __restrict__ dmin_out,
                    int Q, int M, int F, int n_split, int split_len,
                    float idw_half, float eps, float rbf_den, float rbf_rcp,
                    bool vec) {
  using P = Plan<FMAX>;
  constexpr int QT = P::QT;
  constexpr int QB = P::QB;
  constexpr int WT = P::WT;
  constexpr int LD = P::LD;
  // feature quads unrolled: all with the features in registers, else 4
  constexpr int kFeatUnroll = P::kResident ? FMAX / 4 : 4;
  extern __shared__ __align__(16) float s_buf[];
  float* s_q = s_buf + kWarps * 2 * WT * LD;
  __shared__ float s_part[kMaxSplit * 3 * QB];
  __shared__ float2 s_red[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int qb = blockIdx.x;
  const int split = blockIdx.y;
  const int r0 = split * split_len;
  const int n_rows = min(split_len, M - r0);
  const int q_rows = min(QB, Q - qb * QB);
  // the warp's own rows of the split, [w0, w1), through its own two tiles
  float* wbuf = s_buf + warp * 2 * WT * LD;
  const int w_len = (n_rows + kWarps - 1) / kWarps;
  const int w0 = min(n_rows, warp * w_len);
  const int w1 = min(n_rows, w0 + w_len);
  const int n_tiles = (w1 - w0 + WT - 1) / WT;

  // splits: a first cluster barrier phase, waited on before any block
  // writes to another's shared memory, so that every block has started
  if (n_split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::);

  // the block's queries (resident instances, zeros past Q) and the warp's
  // first tile, as two groups of copies
  if constexpr (P::kResident) {
    load_rows<FMAX>(s_q, xq, nullptr, nullptr,
                    static_cast<int64_t>(qb) * QB, q_rows, QB, F, vec, tid,
                    kThreads);
    cp_async_commit();
  }
  if (n_tiles > 0) {
    load_rows<FMAX>(wbuf, xm, y, w, r0 + w0, min(WT, w1 - w0), WT, F, vec,
                    lane, 32);
  }
  cp_async_commit();

  float qf[P::kResident ? QT : 1][P::kResident ? FMAX : 1];
  float qq[QT], wsum[QT], ky[QT], d2min[QT];
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    qq[t] = 0.0f;
    wsum[t] = 0.0f;
    ky[t] = 0.0f;
    d2min[t] = INFINITY;
  }
  // the thread's queries: features and |q|^2, while the tile lands; past
  // F = 64 one query, read from L1 per row
  const int q1 = qb * QB + lane;
  const float* qsrc = xq + static_cast<int64_t>(q1 < Q ? q1 : 0) * F;
  if constexpr (P::kResident) {
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int t = 0; t < QT; ++t) {
      const float* q = s_q + (32 * t + lane) * LD;
#pragma unroll
      for (int f = 0; f < FMAX; f += 4) {
        const float4 u = *reinterpret_cast<const float4*>(q + f);
        qf[t][f] = u.x;
        qf[t][f + 1] = u.y;
        qf[t][f + 2] = u.z;
        qf[t][f + 3] = u.w;
        qq[t] = fmaf(u.x, u.x, qq[t]);
        qq[t] = fmaf(u.y, u.y, qq[t]);
        qq[t] = fmaf(u.z, u.z, qq[t]);
        qq[t] = fmaf(u.w, u.w, qq[t]);
      }
    }
  } else {
#pragma unroll 4
    for (int f = 0; f < FMAX; ++f) {
      const float v = q1 < Q && f < F ? qsrc[f] : 0.0f;
      qq[0] = fmaf(v, v, qq[0]);
    }
  }

  // the warp streams its rows with no block barrier: the next tile's
  // copies go out before this tile's pairs
  for (int it = 0; it < n_tiles; ++it) {
    float* tile = wbuf + (it & 1) * WT * LD;
    const int rows = min(WT, w1 - w0 - it * WT);
    if (it + 1 < n_tiles) {     // the other tile was freed by the last sync
      load_rows<FMAX>(wbuf + ((it + 1) & 1) * WT * LD, xm, y, w,
                      r0 + w0 + (it + 1) * WT,
                      min(WT, w1 - w0 - (it + 1) * WT), WT, F, vec, lane, 32);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    if (lane < rows) {          // |m|^2, a lane a row
      float* row = tile + lane * LD;
      float mm = 0.0f;
#pragma unroll kFeatUnroll
      for (int f = 0; f < FMAX; f += 4) {
        const float4 u = *reinterpret_cast<const float4*>(row + f);
        mm = fmaf(u.x, u.x, mm);
        mm = fmaf(u.y, u.y, mm);
        mm = fmaf(u.z, u.z, mm);
        mm = fmaf(u.w, u.w, mm);
      }
      row[FMAX] = mm;
    }
    __syncwarp();
    const float* m = tile;
    for (int j = 0; j < rows; ++j, m += LD) {
      float g[QT];
#pragma unroll
      for (int t = 0; t < QT; ++t) g[t] = 0.0f;
#pragma unroll kFeatUnroll
      for (int f = 0; f < FMAX; f += 4) {
        const float4 u = *reinterpret_cast<const float4*>(m + f);
        if constexpr (P::kResident) {
#pragma unroll
          for (int t = 0; t < QT; ++t) {
            g[t] = fmaf(qf[t][f], u.x, g[t]);
            g[t] = fmaf(qf[t][f + 1], u.y, g[t]);
            g[t] = fmaf(qf[t][f + 2], u.z, g[t]);
            g[t] = fmaf(qf[t][f + 3], u.w, g[t]);
          }
        } else {
          const float mv[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float qv = q1 < Q && f + i < F ? __ldg(qsrc + f + i) : 0.0f;
            g[0] = fmaf(qv, mv[i], g[0]);
          }
        }
      }
      // |m|^2, y, w
      const float4 a = *reinterpret_cast<const float4*>(m + FMAX);
#pragma unroll
      for (int t = 0; t < QT; ++t) {
        const float d2 = fmaxf(fmaf(-2.0f, g[t], qq[t] + a.x), 0.0f);
        d2min[t] = fminf(d2min[t], d2);
        const float k = weight<KIND>(d2, idw_half, eps, rbf_den, rbf_rcp) * a.z;
        wsum[t] += k;
        ky[t] = fmaf(k, a.y, ky[t]);
      }
    }
    __syncwarp();
  }
  __syncthreads();              // every warp's tiles are free now

  // the warps' partials, met in warp order
  float* red = s_buf;
#pragma unroll
  for (int t = 0; t < QT; ++t) {
    red[(warp * 3 + 0) * QB + 32 * t + lane] = wsum[t];
    red[(warp * 3 + 1) * QB + 32 * t + lane] = ky[t];
    red[(warp * 3 + 2) * QB + 32 * t + lane] = d2min[t];
  }
  __syncthreads();
  const bool has = tid < QB;
  float W = 0.0f, KY = 0.0f, D = INFINITY;
  if (has) {
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      W += red[(v * 3 + 0) * QB + tid];
      KY += red[(v * 3 + 1) * QB + tid];
      D = fminf(D, red[(v * 3 + 2) * QB + tid]);
    }
  }

  if (n_split > 1) {
    // the splits of this query block are one cluster: each writes its
    // partials into the first block's shared memory, which adds them in
    // split order after one cluster barrier (the others exit, and nothing
    // reads their shared memory)
    cg::cluster_group cluster = cg::this_cluster();
    asm volatile("barrier.cluster.wait.aligned;\n" ::);
    if (has) {
      float* part = cluster.map_shared_rank(s_part, 0) + split * 3 * QB;
      part[tid] = W;
      part[QB + tid] = KY;
      part[2 * QB + tid] = D;
    }
    cluster.sync();
    if (split != 0) return;
    if (has) {
      W = 0.0f;
      KY = 0.0f;
      D = INFINITY;
      for (int s = 0; s < n_split; ++s) {
        W += s_part[s * 3 * QB + tid];
        KY += s_part[s * 3 * QB + QB + tid];
        D = fminf(D, s_part[s * 3 * QB + 2 * QB + tid]);
      }
    }
  }

  const int q = qb * QB + tid;
  const bool live = has && q < Q;
  float fallback = 0.0f;
  if (__syncthreads_or(live && !(W > 1e-12f))) {
    const float2 s = fallback_sums(y, w, M, s_red);
    const float wt = fmaxf(s.y, 1e-12f);
    fallback = div_rn(s.x, wt, rcp_rn(wt));
  }
  if (live) {
    const float wc = fmaxf(W, 1e-12f);
    mean_out[q] = W > 1e-12f ? div_rn(KY, wc, rcp_rn(wc)) : fallback;
    dmin_out[q] = sqrtf(D);
  }
}

// queries a block at F features: the instance the launch picks
int block_queries(int F) {
  return F <= 8    ? Plan<8>::QB
         : F <= 16 ? Plan<16>::QB
         : F <= 32 ? Plan<32>::QB
         : F <= 64 ? Plan<64>::QB
         : F <= 128 ? Plan<128>::QB
                    : Plan<256>::QB;
}

constexpr int kMinSplitRows = 64;

// How the launch cuts M measurements on a card of `sms` SMs: n_split
// contiguous splits of split_len rows (the last shorter but not empty),
// each taken by its own block of a cluster per block of queries.  The
// splits bring the blocks up to one an SM where M gives each split
// kMinSplitRows rows, and number at most kMaxSplit.
void plan_split(int Q, int M, int F, int sms, int* n_split,
                int* split_len) {
  const int qb = block_queries(F);
  const int blocks_q = (Q + qb - 1) / qb;
  const int by_rows = (M + kMinSplitRows - 1) / kMinSplitRows;
  int n = sms / blocks_q;
  n = n < by_rows ? n : by_rows;
  n = n < kMaxSplit ? n : kMaxSplit;
  n = n > 1 ? n : 1;
  *split_len = (M + n - 1) / n;
  *n_split = (M + *split_len - 1) / *split_len;
}

template <int FMAX, int KIND>
cudaError_t launch(const float* xq, const float* xm, const float* y,
                   const float* w, float* mean, float* dmin, int Q, int M,
                   int F, float idw_half, float eps, float rbf_den,
                   cudaStream_t stream) {
  const bool vec = F % 4 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(xm) % 16 == 0;
  auto* kernel = fused_interp_kernel<FMAX, KIND>;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return err;
  int n_split = 1, split_len = M;
  plan_split(Q, M, F, sms, &n_split, &split_len);
  // above 48 KB of dynamic shared memory (at F <= 16: 92 KB), on the
  // current device
  const int smem = Plan<FMAX>::kSmemFloats * static_cast<int>(sizeof(float));
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Q + Plan<FMAX>::QB - 1) / Plan<FMAX>::QB, n_split);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = n_split;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, xq, xm, y, w, mean, dmin, Q, M, F,
                            n_split, split_len, idw_half, eps, rbf_den,
                            1.0f / rbf_den, vec);
}

template <int FMAX>
cudaError_t launch_kind(int kind, const float* xq, const float* xm,
                        const float* y, const float* w, float* mean,
                        float* dmin, int Q, int M, int F, float idw_half,
                        float eps, float rbf_den, cudaStream_t stream) {
  if (kind == kRbf)
    return launch<FMAX, kRbf>(xq, xm, y, w, mean, dmin, Q, M, F, idw_half,
                              eps, rbf_den, stream);
  if (kind == kIdwPow)
    return launch<FMAX, kIdwPow>(xq, xm, y, w, mean, dmin, Q, M, F,
                                 idw_half, eps, rbf_den, stream);
  return launch<FMAX, kIdw2>(xq, xm, y, w, mean, dmin, Q, M, F, idw_half,
                             eps, rbf_den, stream);
}

__global__ void reciprocal_kernel(const float* __restrict__ x,
                                  float* __restrict__ out, int64_t n) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    out[i] = rcp_rn(x[i]);
  }
}

}  // namespace

// xq: (Q, F), xm: (M, F), y/w: (M,) float32, row-major; mean/dmin: (Q,)
// float32 outputs, all on the current CUDA device.  Q >= 1, M >= 1,
// 1 <= F <= 256.  rbf != 0 selects the Gaussian weight exp(-d2 / rbf_den),
// 2^-126 <= rbf_den < inf; otherwise IDW 1 / (d2^idw_half + eps),
// eps >= 2^-126.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
extern "C" int fused_interp_launch(const void* xq, const void* xm,
                                   const void* y, const void* w, void* mean,
                                   void* dmin, int Q, int M, int F, int rbf,
                                   float idw_half, float eps, float rbf_den,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || M < 1 || F < 1) return cudaErrorInvalidValue;
  const int kind = rbf ? kRbf : idw_half == 1.0f ? kIdw2 : kIdwPow;
#define REPRO_FI_CASE(FM)                                                   \
  if (F <= FM)                                                              \
    return launch_kind<FM>(                                                 \
        kind, static_cast<const float*>(xq), static_cast<const float*>(xm), \
        static_cast<const float*>(y), static_cast<const float*>(w),         \
        static_cast<float*>(mean), static_cast<float*>(dmin), Q, M, F,      \
        idw_half, eps, rbf_den, s);
  REPRO_FI_CASE(8)
  REPRO_FI_CASE(16)
  REPRO_FI_CASE(32)
  REPRO_FI_CASE(64)
  REPRO_FI_CASE(128)
  REPRO_FI_CASE(256)
#undef REPRO_FI_CASE
  return cudaErrorInvalidValue;
}

// Not on any path: the launch's cut of the measurements on a card of
// `sms` SMs (plan_split), out[0] splits of out[1] rows, for the tests.
extern "C" void fused_interp_split(int Q, int M, int F, int sms, int* out) {
  plan_split(Q, M, F, sms, out, out + 1);
}

// Not on any path: out[i] = rcp_rn(x[i]) (ieee_div.cuh), the weight's
// reciprocal, for the tests.  x, out: n float32 on the current device.
extern "C" int fused_interp_reciprocal(const void* x, void* out, long long n,
                                       void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const int64_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  reciprocal_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), n);
  return cudaGetLastError();
}
