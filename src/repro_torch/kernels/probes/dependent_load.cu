// A probe of the card, not a kernel of any path: the time of one global
// load whose address depends on the load before it, as a serial walk's
// table lookups do (csrc/anneal_walk.cu).  chip_smoke.py times it to give
// that kernel its latency bound: S dependent steps take at least S times
// this, whatever the bytes allow.
//
// One thread follows `next` from word 0 for `steps` loads.  The caller
// lays a single cycle through the buffer's 32-byte sectors in a random
// order (the word at a sector's start holds the next sector's start), so
// each load waits on the one before and no two neighbours share a sector.
// Read through a const __restrict__ pointer, as the walk reads its table.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void chase_kernel(const uint32_t* __restrict__ next,
                             long long steps, uint32_t* __restrict__ out) {
  uint32_t i = 0;
  for (long long s = 0; s < steps; ++s) i = next[i];
  *out = i;  // keeps the chain live
}

}  // namespace

extern "C" int dependent_load_chase(const uint32_t* next, long long steps,
                                    uint32_t* out, void* stream) {
  if (steps < 0) return cudaErrorInvalidValue;
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, steps,
                                                               out);
  return cudaGetLastError();
}
