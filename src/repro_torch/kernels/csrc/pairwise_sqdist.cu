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
// Bound on this card: bytes, and nearly all of them written.  At the
// surrogate's grid chunk (Q 8,192 grid states against M 1,024 probes, F 16
// features) the (Q, M) result is 33.6 MB of the 34.1 MB moved, 0.010 ms at
// 3.35 TB/s, against 2 F Q M operations of products (0.004 ms at 67
// TFLOP/s float32).  So the design is built around the stores:
//
// - A warp writes whole 128-byte lines: lane l owns probes 4 l .. 4 l + 3 of
//   the block's 128 and stores their 4 distances as one float4 with a
//   streaming hint (`__stcs`: nothing here reads the result back).  Where
//   M % 4 != 0 (rows not 16-byte aligned) or at the ragged right edge the
//   same lanes store their floats one by one.
// - F <= 16 (the surrogate's encodings; the resident kernel): a thread
//   keeps its 4 probes' features in registers and walks its warp's 32
//   queries one at a time, storing each query's distances as soon as they
//   are summed, so the stores stream out from the first query on, beside
//   the sums.  The block's 256 queries and 128 probes are staged through
//   shared memory by coalesced 16-byte loads, once.
// - F > 16 (the tiled kernel): a block of 64 queries x 128 probes, each
//   thread 8 queries x 4 probes (32 sums in registers), features staged 32
//   at a time; the stores follow the last feature.
// - Only the features there are are summed, rounded up to 4 (zeros past
//   F): F 16 runs 16 steps.  Each norm is summed once a block, by one
//   thread, not once for every pair.
//
// Invariant: a query equal to a probe gives exactly 0.  The norms and the
// dot products run the same fmaf chain in feature order (the zeros past F
// add +0 to both alike), so ||q||^2 + ||m||^2 and 2 q.m are the same float
// and their difference is 0, however the compiler contracts it.  This is
// why the products stay on the float32 pipe: TF32 tensor cores would round
// the dot product and not the norms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 128;                     // probes a block, 4 a lane
constexpr int kResidentRows = 32;              // queries a warp, F <= 16
constexpr int kTileRows = 8;                   // queries a thread, F > 16
constexpr int kTileF = 32;                     // features staged, F > 16

// 4 features of a row from f (f % 4 == 0, f < F), zero past F: one 16-byte
// load when F % 4 == 0 and the rows are 16-byte aligned (vec)
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int f,
                                        int F, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + f));
  float4 v;
  v.x = __ldg(row + f);
  v.y = f + 1 < F ? __ldg(row + f + 1) : 0.0f;
  v.z = f + 2 < F ? __ldg(row + f + 2) : 0.0f;
  v.w = f + 3 < F ? __ldg(row + f + 3) : 0.0f;
  return v;
}

// the squared norm of 4 features, continuing the chain in n
__device__ __forceinline__ float norm4(float4 v, float n) {
  n = fmaf(v.x, v.x, n);
  n = fmaf(v.y, v.y, n);
  n = fmaf(v.z, v.z, n);
  return fmaf(v.w, v.w, n);
}

// acc[c] += q m_c for the 4 probes' values m = (m_0, m_1, m_2, m_3)
__device__ __forceinline__ void fma4(float (&acc)[4], float q, float4 m) {
  acc[0] = fmaf(q, m.x, acc[0]);
  acc[1] = fmaf(q, m.y, acc[1]);
  acc[2] = fmaf(q, m.z, acc[2]);
  acc[3] = fmaf(q, m.w, acc[3]);
}

// query i's distances to probes j .. j + 3 (j < M), from its norm qq, the
// probes' norms mm and the dot products acc; whole: all 4 in range and the
// address 16-byte aligned
__device__ __forceinline__ void store4(float* __restrict__ d2, int i, int M,
                                       int j, float qq, float4 mm,
                                       const float (&acc)[4], bool whole) {
  float4 d;
  d.x = fmaxf(qq + mm.x - 2.0f * acc[0], 0.0f);
  d.y = fmaxf(qq + mm.y - 2.0f * acc[1], 0.0f);
  d.z = fmaxf(qq + mm.z - 2.0f * acc[2], 0.0f);
  d.w = fmaxf(qq + mm.w - 2.0f * acc[3], 0.0f);
  float* dst = d2 + static_cast<long long>(i) * M + j;
  if (whole) {
    __stcs(reinterpret_cast<float4*>(dst), d);
  } else {
    __stcs(dst, d.x);
    if (j + 1 < M) __stcs(dst + 1, d.y);
    if (j + 2 < M) __stcs(dst + 2, d.z);
    if (j + 3 < M) __stcs(dst + 3, d.w);
  }
}

// F <= 16, FP = F rounded up to 4.  A block: 256 queries (32 a warp) x 128
// probes.
template <int FP>
__global__ void __launch_bounds__(kThreads)
pairwise_sqdist_resident_kernel(const float* __restrict__ xq,
                                const float* __restrict__ xm,
                                float* __restrict__ d2, int Q, int M, int F,
                                int n_col_tiles, int vec_load,
                                int vec_store) {
  constexpr int kG = FP / 4;                   // float4 groups a row
  constexpr int kRows = kWarps * kResidentRows;
  // queries padded by 4 words: a lane's float4 reads of its own query (the
  // norm) fall on distinct banks; the sums' reads are broadcasts
  __shared__ __align__(16) float s_q[kRows][FP + 4];
  __shared__ __align__(16) float s_m[FP][kCols];   // feature-major
  __shared__ __align__(16) float s_mm[kCols];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (blockIdx.x / n_col_tiles) * kRows;
  const int m0 = (blockIdx.x % n_col_tiles) * kCols;

  for (int e = tid; e < kRows * kG; e += kThreads) {
    const int r = e / kG, g = e % kG;
    *reinterpret_cast<float4*>(&s_q[r][4 * g]) = q0 + r < Q
        ? load4(xq + static_cast<long long>(q0 + r) * F, 4 * g, F, vec_load)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int e = tid; e < kCols * kG; e += kThreads) {
    const int col = e % kCols, g = e / kCols;
    const float4 v = m0 + col < M
        ? load4(xm + static_cast<long long>(m0 + col) * F, 4 * g, F, vec_load)
        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_m[4 * g][col] = v.x;
    s_m[4 * g + 1][col] = v.y;
    s_m[4 * g + 2][col] = v.z;
    s_m[4 * g + 3][col] = v.w;
  }
  if (tid < kCols && m0 + tid < M) {
    const float* row = xm + static_cast<long long>(m0 + tid) * F;
    float nrm = 0.0f;
#pragma unroll
    for (int g = 0; g < kG; ++g)
      nrm = norm4(load4(row, 4 * g, F, vec_load), nrm);
    s_mm[tid] = nrm;
  }
  __syncthreads();

  const int j = m0 + 4 * lane;
  float4 m[FP];        // m[f]: feature f of the lane's probes j .. j + 3
#pragma unroll
  for (int f = 0; f < FP; ++f)
    m[f] = *reinterpret_cast<const float4*>(&s_m[f][4 * lane]);
  const float4 mm = *reinterpret_cast<const float4*>(&s_mm[4 * lane]);
  const int rb = warp * kResidentRows;         // the warp's first query
  float qq_lane = 0.0f;                        // lane l: query rb + l's norm
#pragma unroll
  for (int g = 0; g < kG; ++g)
    qq_lane = norm4(*reinterpret_cast<const float4*>(&s_q[rb + lane][4 * g]),
                    qq_lane);
  const bool whole = vec_store && j + 3 < M;
  for (int r = 0; r < kResidentRows; ++r) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      const float4 q = *reinterpret_cast<const float4*>(&s_q[rb + r][4 * g]);
      fma4(acc, q.x, m[4 * g]);
      fma4(acc, q.y, m[4 * g + 1]);
      fma4(acc, q.z, m[4 * g + 2]);
      fma4(acc, q.w, m[4 * g + 3]);
    }
    const float qq = __shfl_sync(0xffffffffu, qq_lane, r);
    const int i = q0 + rb + r;
    if (i < Q && j < M) store4(d2, i, M, j, qq, mm, acc, whole);
  }
}

// F > 16.  A block: 64 queries (8 a warp, each thread all 8) x 128 probes.
__global__ void __launch_bounds__(kThreads)
pairwise_sqdist_tiled_kernel(const float* __restrict__ xq,
                             const float* __restrict__ xm,
                             float* __restrict__ d2, int Q, int M, int F,
                             int n_col_tiles, int vec_load, int vec_store) {
  constexpr int kG = kTileF / 4;               // float4 groups a chunk
  constexpr int kRows = kWarps * kTileRows;
  // queries padded by 4 words: the norm threads' float4 reads of 8
  // consecutive queries fall on distinct banks
  __shared__ __align__(16) float s_q[kRows][kTileF + 4];
  __shared__ __align__(16) float s_m[kTileF][kCols];  // feature-major
  __shared__ __align__(16) float s_qq[kRows];
  __shared__ __align__(16) float s_mm[kCols];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = (blockIdx.x / n_col_tiles) * kRows;
  const int m0 = (blockIdx.x % n_col_tiles) * kCols;
  const int rb = warp * kTileRows;             // the warp's first query

  float acc[kTileRows][4];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  float nrm = 0.0f;      // threads 0-63: a query's norm; 64-191: a probe's

  for (int f0 = 0; f0 < F; f0 += kTileF) {
    const int ng = (min(kTileF, F - f0) + 3) / 4;  // groups of features
    __syncthreads();   // the previous chunk is consumed
    for (int e = tid; e < kRows * kG; e += kThreads) {
      const int row = e / kG, g = e % kG;
      if (g >= ng) continue;
      *reinterpret_cast<float4*>(&s_q[row][4 * g]) = q0 + row < Q
          ? load4(xq + static_cast<long long>(q0 + row) * F, f0 + 4 * g, F,
                  vec_load)
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    for (int e = tid; e < kCols * kG; e += kThreads) {
      const int col = e % kCols, g = e / kCols;
      if (g >= ng) continue;
      const float4 v = m0 + col < M
          ? load4(xm + static_cast<long long>(m0 + col) * F, f0 + 4 * g, F,
                  vec_load)
          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      s_m[4 * g][col] = v.x;
      s_m[4 * g + 1][col] = v.y;
      s_m[4 * g + 2][col] = v.z;
      s_m[4 * g + 3][col] = v.w;
    }
    __syncthreads();
    if (tid < kRows) {
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g >= ng) break;
        nrm = norm4(*reinterpret_cast<const float4*>(&s_q[tid][4 * g]), nrm);
      }
    } else if (tid < kRows + kCols) {
#pragma unroll
      for (int f = 0; f < kTileF; ++f) {
        if (f >= 4 * ng) break;
        const float v = s_m[f][tid - kRows];
        nrm = fmaf(v, v, nrm);
      }
    }
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      if (g >= ng) break;
      float4 m[4];     // m[k]: feature 4 g + k of the lane's 4 probes
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m[k] = *reinterpret_cast<const float4*>(&s_m[4 * g + k][4 * lane]);
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float4 q =
            *reinterpret_cast<const float4*>(&s_q[rb + r][4 * g]);
        fma4(acc[r], q.x, m[0]);
        fma4(acc[r], q.y, m[1]);
        fma4(acc[r], q.z, m[2]);
        fma4(acc[r], q.w, m[3]);
      }
    }
  }
  if (tid < kRows)
    s_qq[tid] = nrm;
  else if (tid < kRows + kCols)
    s_mm[tid - kRows] = nrm;
  __syncthreads();

  const int j = m0 + 4 * lane;
  if (j >= M) return;
  const float4 mm = *reinterpret_cast<const float4*>(&s_mm[4 * lane]);
  const bool whole = vec_store && j + 3 < M;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int i = q0 + rb + r;
    if (i >= Q) break;
    store4(d2, i, M, j, s_qq[rb + r], mm, acc[r], whole);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// xq (Q, F), xm (M, F), d2 (Q, M): float32, contiguous.
extern "C" int pairwise_sqdist_launch(const float* xq, const float* xm,
                                      float* d2, int Q, int M, int F,
                                      void* stream) {
  if (Q < 1 || M < 1 || F < 1) return cudaErrorInvalidValue;
  const int n_col_tiles = (M + kCols - 1) / kCols;
  const int rows = F <= 16 ? kWarps * kResidentRows : kWarps * kTileRows;
  const long long blocks =
      static_cast<long long>((Q + rows - 1) / rows) * n_col_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec_load = F % 4 == 0 && aligned16(xq) && aligned16(xm);
  const int vec_store = M % 4 == 0 && aligned16(d2);
  const dim3 grid(static_cast<unsigned>(blocks));
  auto s = static_cast<cudaStream_t>(stream);
  if (F <= 4)
    pairwise_sqdist_resident_kernel<4><<<grid, kThreads, 0, s>>>(
        xq, xm, d2, Q, M, F, n_col_tiles, vec_load, vec_store);
  else if (F <= 8)
    pairwise_sqdist_resident_kernel<8><<<grid, kThreads, 0, s>>>(
        xq, xm, d2, Q, M, F, n_col_tiles, vec_load, vec_store);
  else if (F <= 12)
    pairwise_sqdist_resident_kernel<12><<<grid, kThreads, 0, s>>>(
        xq, xm, d2, Q, M, F, n_col_tiles, vec_load, vec_store);
  else if (F <= 16)
    pairwise_sqdist_resident_kernel<16><<<grid, kThreads, 0, s>>>(
        xq, xm, d2, Q, M, F, n_col_tiles, vec_load, vec_store);
  else
    pairwise_sqdist_tiled_kernel<<<grid, kThreads, 0, s>>>(
        xq, xm, d2, Q, M, F, n_col_tiles, vec_load, vec_store);
  return cudaGetLastError();
}
