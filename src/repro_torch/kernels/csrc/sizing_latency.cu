// M/M/c tier sojourns + visit-weighted DAG critical path, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sizing_latency.py
// (`sizing_latency`, body `_sizing_kernel`).  For every (row, tier) cell:
// the Erlang-C M/M/c sojourn from the Erlang-B recurrence run to the static
// `c_max` (B_c picked where `k == repl` exactly, as floats; cells with
// `repl * mu - lam <= 1e-9` saturate to `sat_s`); then, per row, K Jacobi
// steps of L[v] = w[v] T[v] + max(0, max_{adj[v,u]} L[u]) over the (K, K)
// adjacency.
//
// Bound on this card: memory.  A row reads four (K,) float32 inputs and
// writes two, 24 K bytes; at the container-sizing grid (B = 196,608 rows,
// K = 8) that is 37.7 MB, about 11 us at 3.35 TB/s.  The arithmetic
// (c_max Erlang steps plus K^2 compare-selects per relaxation step) is a
// few hundred operations per row, far below the card's rate.
//
// Design: one thread per row.  The row's K <= 32 tier values live in
// registers (arrays indexed only by unrolled loop counters), padded to a
// compile-time MAXK with load-free entries (node 0, no edges), so the
// relaxation needs no bounds checks.  The adjacency is staged once per block
// as one K-bit child mask per tier in shared memory.  Nothing is padded in
// device memory: the kernel reads and writes exactly B x K cells.  Built
// with -fmad=false so each multiply and add rounds on its own, as the plain
// PyTorch version's separate elementwise ops do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;

template <int MAXK>
__global__ void __launch_bounds__(kThreads)
sizing_latency_kernel(const float* __restrict__ lam,
                      const float* __restrict__ mu,
                      const float* __restrict__ repl,
                      const float* __restrict__ visit_w,
                      const uint8_t* __restrict__ adj,
                      float* __restrict__ soj,
                      float* __restrict__ path,
                      int B, int K, int c_max, float sat_s) {
  __shared__ uint32_t child_mask[MAXK];
  for (int v = threadIdx.x; v < MAXK; v += blockDim.x) {
    uint32_t m = 0;
    if (v < K) {
      for (int u = 0; u < K; ++u) {
        if (adj[v * K + u]) m |= (1u << u);
      }
    }
    child_mask[v] = m;
  }
  __syncthreads();

  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (b >= B) return;
  const int64_t row = b * K;

  float node[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    node[k] = 0.0f;
    if (k < K) {
      const float l = lam[row + k];
      const float m = mu[row + k];
      const float c = repl[row + k];
      const float a = l / m;                      // offered load (Erlangs)
      float bk = 1.0f;
      float b_c = 0.0f;
      for (int i = 1; i <= c_max; ++i) {
        const float ab = a * bk;
        const float fi = static_cast<float>(i);
        bk = ab / (fi + ab);
        if (fi == c) b_c = bk;
      }
      const float rho = a / fmaxf(c, 1.0f);
      const float p_wait = b_c / fmaxf(1.0f - rho * (1.0f - b_c), 1e-12f);
      const float slack = c * m - l;              // spare service capacity
      const float t = slack > 1e-9f
                          ? p_wait / fmaxf(slack, 1e-12f) + 1.0f / m
                          : sat_s;
      soj[row + k] = t;
      node[k] = visit_w[row + k] * t;
    }
  }

  float lat[MAXK];
  float nxt[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) lat[k] = node[k];
#pragma unroll 1
  for (int it = 0; it < K; ++it) {
#pragma unroll
    for (int v = 0; v < MAXK; ++v) {
      const uint32_t m = child_mask[v];
      float child = kNeg;
#pragma unroll
      for (int u = 0; u < MAXK; ++u) {
        if ((m >> u) & 1u) child = fmaxf(child, lat[u]);
      }
      nxt[v] = node[v] + fmaxf(child, 0.0f);
    }
#pragma unroll
    for (int v = 0; v < MAXK; ++v) lat[v] = nxt[v];
  }
#pragma unroll
  for (int k = 0; k < MAXK; ++k) {
    if (k < K) path[row + k] = lat[k];
  }
}

template <int MAXK>
cudaError_t launch(const void* lam, const void* mu, const void* repl,
                   const void* visit_w, const void* adj, void* soj,
                   void* path, int B, int K, int c_max, float sat_s,
                   cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  sizing_latency_kernel<MAXK><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(lam), static_cast<const float*>(mu),
      static_cast<const float*>(repl), static_cast<const float*>(visit_w),
      static_cast<const uint8_t*>(adj), static_cast<float*>(soj),
      static_cast<float*>(path), B, K, c_max, sat_s);
  return cudaGetLastError();
}

}  // namespace

// lam/mu/repl/visit_w: (B, K) float32, row-major; adj: (K, K) uint8;
// soj/path: (B, K) float32 outputs, all on the current CUDA device.
// 1 <= K <= 32, B >= 1.  Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
extern "C" int sizing_latency_launch(const void* lam, const void* mu,
                                     const void* repl, const void* visit_w,
                                     const void* adj, void* soj, void* path,
                                     int B, int K, int c_max, float sat_s,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || K < 1 || c_max < 1) return cudaErrorInvalidValue;
  if (K <= 8)
    return launch<8>(lam, mu, repl, visit_w, adj, soj, path, B, K, c_max,
                     sat_s, s);
  if (K <= 16)
    return launch<16>(lam, mu, repl, visit_w, adj, soj, path, B, K, c_max,
                      sat_s, s);
  if (K <= 32)
    return launch<32>(lam, mu, repl, visit_w, adj, soj, path, B, K, c_max,
                      sat_s, s);
  return cudaErrorInvalidValue;
}
