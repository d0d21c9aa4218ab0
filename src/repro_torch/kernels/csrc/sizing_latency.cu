// M/M/c tier sojourns + visit-weighted DAG critical path, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sizing_latency.py
// (`sizing_latency`, body `_sizing_kernel`).  For every (row, tier) cell:
// the Erlang-C M/M/c sojourn from the Erlang-B recurrence (B_c picked
// where `k == repl` exactly, as floats, for k up to the static `c_max`;
// cells with `repl * mu - lam <= 1e-9` saturate to `sat_s`); then, per
// row, the heaviest path L[v] = w[v] T[v] + max(0, max_{adj[v,u]} L[u])
// over the (K, K) adjacency, which the plain version takes as K Jacobi
// steps.
//
// Bound on this card: memory.  A row reads four (K,) float32 inputs and
// writes two, 24 K bytes; at the container-sizing grid (B = 196,608 rows,
// K = 8) that is 37.7 MB, about 11 us at 3.35 TB/s.  The arithmetic is a
// few hundred operations per row, far below the card's rate.
//
// Design: a block of 256 threads takes 512 / K rows (64 at K = 8), all
// cells of which are one contiguous span of each array; 8 blocks an SM.
//   - Cells: thread t takes cells t and t + 256 of the span, both cells'
//     four loads issued first, so every load and store of a warp covers 32
//     consecutive floats (4 sectors, the coalesced count).  The Erlang-B
//     recurrence stops at min(repl, c_max): past k = repl it no longer
//     changes B_c, so the result is the same bits.  Each cell writes its
//     sojourn straight out and its node weight w T into shared memory, one
//     padding word every 32 (index c + c / 32), which keeps both the
//     cell-wise and the row-wise accesses free of bank conflicts at K = 4,
//     8, 16 and 32.
//   - Order: before its cells, warp 0 stages the child masks (one K-bit
//     mask per tier, a lane a tier) and turns them into a reverse
//     topological order by Kahn's algorithm, a ballot a wave.  When adj
//     is acyclic, one pass in that order, a thread a row, computes every
//     L[v] from its children's final values: the same additions and maxes,
//     over the same operands in the same child order, as the K-th Jacobi
//     step, so the same bits (a Jacobi value is final once its steps
//     exceed the height of its node, and K exceeds every height).  When
//     adj has a cycle the K Jacobi steps run as before, in two more shared
//     arrays.
//   - Path: the rows' L values leave through shared memory by the same
//     coalesced cell-wise stores.
// Built with -fmad=false so each multiply and add rounds on its own, as
// the plain PyTorch version's separate elementwise ops do; its divisions
// are IEEE (`/`), so the kernel is bit-equal to the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kThreads = 256;
constexpr int kCells = 512;                   // cells a block, at most
constexpr int kPad = kCells + kCells / 32;    // one shared array, padded
constexpr int kPerThread = kCells / kThreads;

__device__ __forceinline__ int slot(int c) { return c + (c >> 5); }

// L[v] = node[v] + max(0, max over v's children u of lat[u]), the children
// in index order, for one row (offsets into the padded arrays)
__device__ __forceinline__ float relax(const float* node, const float* lat,
                                       int row0, int v, uint32_t children) {
  float child = kNeg;
  while (children) {
    const int u = __ffs(children) - 1;
    children &= children - 1;
    child = fmaxf(child, lat[slot(row0 + u)]);
  }
  return node[slot(row0 + v)] + fmaxf(child, 0.0f);
}

__global__ void __launch_bounds__(kThreads)
sizing_latency_kernel(const float* __restrict__ lam,
                      const float* __restrict__ mu,
                      const float* __restrict__ repl,
                      const float* __restrict__ visit_w,
                      const uint8_t* __restrict__ adj,
                      float* __restrict__ soj,
                      float* __restrict__ path,
                      int B, int K, int c_max, float sat_s) {
  __shared__ float s_node[kPad];
  __shared__ float s_a[kPad];       // the Jacobi steps' two buffers
  __shared__ float s_b[kPad];
  __shared__ uint32_t s_child[32];
  __shared__ int s_order[32];
  __shared__ bool s_acyclic;

  const int tid = threadIdx.x;
  const int rows_per_block = kCells / K;
  const int64_t row_base = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int rows = B - row_base < rows_per_block
                       ? static_cast<int>(B - row_base)
                       : rows_per_block;
  const int cells = rows * K;
  const int64_t cell_base = row_base * K;

  float l[kPerThread], m[kPerThread], k[kPerThread], wv[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = tid + j * kThreads;
    if (c < cells) {
      l[j] = lam[cell_base + c];
      m[j] = mu[cell_base + c];
      k[j] = repl[cell_base + c];
      wv[j] = visit_w[cell_base + c];
    }
  }

  // warp 0: the child masks and, by Kahn's algorithm, a reverse
  // topological order of the tiers (each wave of tiers whose children are
  // all placed, in index order); a cycle leaves some tier unplaced
  if (tid < 32) {
    uint32_t mask = 0;
    if (tid < K) {
      for (int u = 0; u < K; ++u) {
        if (adj[tid * K + u]) mask |= 1u << u;
      }
    }
    s_child[tid] = mask;
    uint32_t placed = 0;
    int n = 0;
    for (;;) {
      const bool ready = tid < K && !((placed >> tid) & 1u) &&
                         (mask & ~placed) == 0u;
      const uint32_t wave = __ballot_sync(0xffffffffu, ready);
      if (wave == 0u) break;
      if (ready) s_order[n + __popc(wave & ((1u << tid) - 1u))] = tid;
      n += __popc(wave);
      placed |= wave;
    }
    if (tid == 0) s_acyclic = n == K;
  }

  // cells: Erlang C, sojourn out, node weight to shared memory
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int c = tid + j * kThreads;
    if (c >= cells) break;
    const float a = l[j] / m[j];                  // offered load (Erlangs)
    float bk = 1.0f;
    float b_c = 0.0f;
    for (int n = 1; n <= c_max && static_cast<float>(n) <= k[j]; ++n) {
      const float ab = a * bk;
      const float fn = static_cast<float>(n);
      bk = ab / (fn + ab);
      if (fn == k[j]) b_c = bk;
    }
    const float rho = a / fmaxf(k[j], 1.0f);
    const float p_wait = b_c / fmaxf(1.0f - rho * (1.0f - b_c), 1e-12f);
    const float slack = k[j] * m[j] - l[j];      // spare service capacity
    const float t = slack > 1e-9f
                        ? p_wait / fmaxf(slack, 1e-12f) + 1.0f / m[j]
                        : sat_s;
    soj[cell_base + c] = t;
    s_node[slot(c)] = wv[j] * t;
  }
  __syncthreads();

  for (int r = tid; r < rows; r += kThreads) {
    const int row0 = r * K;
    if (s_acyclic) {
      for (int i = 0; i < K; ++i) {           // in place: children are final
        const int v = s_order[i];
        s_node[slot(row0 + v)] = relax(s_node, s_node, row0, v, s_child[v]);
      }
    } else {
      const float* lat = s_node;
      float* nxt = s_a;
      for (int it = 0; it < K; ++it) {
        for (int v = 0; v < K; ++v) {
          nxt[slot(row0 + v)] = relax(s_node, lat, row0, v, s_child[v]);
        }
        lat = nxt;
        nxt = nxt == s_a ? s_b : s_a;
      }
      for (int v = 0; v < K; ++v) {
        s_node[slot(row0 + v)] = lat[slot(row0 + v)];
      }
    }
  }
  __syncthreads();

  for (int c = tid; c < cells; c += kThreads) {
    path[cell_base + c] = s_node[slot(c)];
  }
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
  if (B < 1 || K < 1 || K > 32 || c_max < 1) return cudaErrorInvalidValue;
  const int rows_per_block = kCells / K;
  const int64_t blocks = (static_cast<int64_t>(B) + rows_per_block - 1) /
                         rows_per_block;
  sizing_latency_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(lam), static_cast<const float*>(mu),
      static_cast<const float*>(repl), static_cast<const float*>(visit_w),
      static_cast<const uint8_t*>(adj), static_cast<float*>(soj),
      static_cast<float*>(path), B, K, c_max, sat_s);
  return cudaGetLastError();
}
