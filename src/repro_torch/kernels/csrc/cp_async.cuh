// Asynchronous copies from device to shared memory (cp.async), shared by
// flash_decode.cu and fused_interp.cu.  tensor_core.cuh keeps its own
// copies: that header belongs to the attention kernels, whose edits need
// not rebuild these.
#pragma once

#include <stdint.h>

namespace repro_async {

// 16 bytes, asynchronously; the first src_bytes (0 or 16) are read, the
// rest zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src), "r"(src_bytes));
}
// 4 bytes, the same way (no zero fill)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

}  // namespace repro_async
