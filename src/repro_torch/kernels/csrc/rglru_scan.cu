// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t (h_{-1} = 0), for
// Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (`rglru_scan`, body `_rglru_kernel`): per channel (b, r) of a, b
// (B, S, R) float32, the sequential recurrence over S, written to h
// (B, S, R) float32.  Each step is one multiply and one add, each rounded
// on its own (__fmul_rn / __fadd_rn, and the file builds with
// -fmad=false), so the result is bit-equal to the plain PyTorch version's
// two elementwise ops per step.
//
// Bound on this card: bytes.  a and b are read once and h written once,
// 12 bytes per element: at recurrentgemma-2b's prefill (B 16, S 512,
// R 2,560) 252 MB, 0.075 ms at 3.35 TB/s; the arithmetic (2 operations an
// element) is far below the card's rate.
//
// Design: the TPU kernel keeps h in VMEM scratch across sequence tiles of
// a sequential grid axis; here one thread owns a channel and keeps h in a
// register for the whole sequence.  Neighbouring threads own neighbouring
// channels r, so every load and store of a warp is one 128-byte line.
// The step's multiply-add depends on the step before, so the loads are
// issued ahead of it: a thread loads kAhead steps of a and b while it
// folds in the previous kAhead, which keeps 2 * kAhead loads in flight
// per thread and the memory busy.  S need not be a multiple of kAhead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kAhead = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int B, int S, int R) {
  const long long ch = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
  if (ch >= static_cast<long long>(B) * R) return;
  const long long bi = ch / R;
  const long long base = bi * S * R + ch % R;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  const long long step = R;

  float acc = 0.0f;
  const int s_full = S - S % kAhead;
  float av[kAhead], bv[kAhead];
  if (s_full > 0) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      av[u] = __ldg(ap + u * step);
      bv[u] = __ldg(bp + u * step);
    }
  }
  for (int t = 0; t < s_full; t += kAhead) {
    float an[kAhead], bn[kAhead];
    const bool more = t + kAhead < s_full;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      an[u] = more ? __ldg(ap + (t + kAhead + u) * step) : 0.0f;
      bn[u] = more ? __ldg(bp + (t + kAhead + u) * step) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      acc = __fadd_rn(__fmul_rn(av[u], acc), bv[u]);
      hp[(t + u) * step] = acc;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      av[u] = an[u];
      bv[u] = bn[u];
    }
  }
  for (int t = s_full; t < S; ++t) {
    acc = __fadd_rn(__fmul_rn(__ldg(ap + t * step), acc),
                    __ldg(bp + t * step));
    hp[t * step] = acc;
  }
}

}  // namespace

// a, b, h: (B, S, R) float32, contiguous.
extern "C" int rglru_scan_launch(const float* a, const float* b, float* h,
                                 int B, int S, int R, void* stream) {
  if (B < 1 || S < 1 || R < 1) return cudaErrorInvalidValue;
  const long long channels = static_cast<long long>(B) * R;
  const unsigned blocks =
      static_cast<unsigned>((channels + kThreads - 1) / kThreads);
  rglru_scan_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a, b, h, B, S, R);
  return cudaGetLastError();
}
