// Sums across the lanes of a warp, shared by flash_decode.cu and wkv6.cu.
#pragma once

namespace repro_warp {

// The xor tree over lane offsets O, O / 2, ..., 1 of each lane's N partial
// sums at once, as a reduce-scatter: at offset O a lane keeps the half of
// its sums whose index bit matches its lane bit O and adds its partner's
// copy of that half, so every addition pairs the same two values as the
// plain tree (x += shfl_xor(x, o) for each sum) would, with one shuffle a
// sum at each level instead of one per sum.  Lane l ends with the whole
// sum of index (l % 2O) >> (log2(2O) - log2 N) (N <= 2O, powers of two).
template <int N, int O>
__device__ __forceinline__ float tree_scatter(const float (&p)[N], int lane) {
  if constexpr (N == 1) {
    float x = p[0];
#pragma unroll
    for (int o = O; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
  } else {
    const bool upper = (lane & O) != 0;
    float h[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? p[i] : p[i + N / 2];
      const float keep = upper ? p[i + N / 2] : p[i];
      h[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    return tree_scatter<N / 2, O / 2>(h, lane);
  }
}

}  // namespace repro_warp
