// Flash decode: one new query token per sequence against a masked KV cache,
// for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (`flash_decode`, body `_decode_kernel`).  For batch row b and kv head
// kvh, whose G grouped query heads are h = kvh * G + g, it computes the
// model's decode attention (models/attention.py `decode_attend`) at the
// model's rounding points:
//   r_gj = q_g . k_j summed in float32, rounded to the input type
//   s_gj = r_gj / sqrt(hd), then softcap * tanh(s_gj / softcap) when
//          softcap > 0; only slots j with valid[b, j] take part
//   w_gj = softmax_j(s_gj) in float32, rounded to the input type
//   o_g  = sum_j w_gj v_j summed in float32, rounded to the input type;
//          0 when no slot is valid (the TPU kernel's guard).
// For float32 inputs the roundings do nothing.
//
// Bound on this card: bytes.  Every valid cache row is read once (k and v,
// 2 * hd elements per (b, kvh, slot)) for 4 * G * hd operations; at the
// serve path's step (B 16, K 8, W 529, hd 128, G 4, bf16) that is 34.7 MB,
// 0.0104 ms at 3.35 TB/s, against 0.2 GFLOP; at recurrentgemma-2b's step
// (B 16, K 1, W 529, hd 256, G 10) 8.7 MB, 0.0026 ms.
//
// Design: one block of 8 warps per (b, kvh) holds its G query heads, so a
// cache row is read for all G heads at once (the TPU kernel's grouping).
// A thread keeps hd / 32 query values and as many accumulators per head
// in registers, so a block holds at most 8 heads up to hd 128 and 4 at
// hd 256; a kv head with more query heads (recurrentgemma-2b: 10 at hd
// 256) splits them into groups of equal size, one block each, which read
// the same cache rows (from L2 after the first).
// The cache is read in place in the model's (B, W, K, hd) layout: the TPU
// wrapper transposed both caches to (B, K, W, hd) on every call, a full
// cache copy per layer per token, which this kernel does not need.  The
// rounded weights need each head's max and sum first, so the slots are
// streamed twice: pass 1 reads k and keeps each warp's running max and sum
// of exponentials, which the 8 warps then combine through shared memory
// (as the TPU kernel combined per-tile statistics); pass 2 reads k and v,
// recomputes the scores and accumulates the rounded weights times v.
// Reading k twice moves 1.5x the bytes of the bound; a one-pass float32
// kernel kept the card's model outside the bf16 tolerance of the host's
// plain path at full width (max logit gap 0.055 on a 2-layer qwen3-8b).
// Each warp streams its own runs of kRows consecutive slots: it issues all
// of a run's loads (16-byte vector loads where the head dim allows), then
// folds the rows in; lane l holds head-dim elements
// [l * hd / 32, (l + 1) * hd / 32), and the run's kRows x G dot products
// are reduced across the warp by shuffles, all together.  W need not be a multiple of
// anything; invalid slots are skipped, not loaded.  Splitting W over
// several blocks (split-K) is left for a later change: with B * K = 128
// blocks on 132 SMs qwen3-8b's serve path fills the card once, and
// recurrentgemma-2b's (B 16, K 1, three head groups) has 48 blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                 // slots per run of one warp
constexpr float kNegInf = -0.7f * FLT_MAX;

// NW raw 32-bit words from p, by 16-, 8- or 4-byte loads
template <int NW>
__device__ __forceinline__ void load_words(const void* p, uint32_t (&w)[NW]) {
  if constexpr (NW % 4 == 0) {
#pragma unroll
    for (int c = 0; c < NW / 4; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      w[4 * c] = u.x; w[4 * c + 1] = u.y; w[4 * c + 2] = u.z;
      w[4 * c + 3] = u.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x; w[1] = u.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kPerWord = 1;
  __device__ static float get(const float* p, int i) { return p[i]; }
  __device__ static void words_to_f(const uint32_t* w, float* x, int nw) {
#pragma unroll
    for (int i = 0; i < nw; ++i) x[i] = __uint_as_float(w[i]);
  }
  __device__ static void put(float* p, float x) { *p = x; }
  __device__ static float round(float x) { return x; }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kPerWord = 2;
  __device__ static float get(const __nv_bfloat16* p, int i) {
    return __bfloat162float(p[i]);
  }
  // little endian: element 2i is the low half of word i (exact widening)
  __device__ static void words_to_f(const uint32_t* w, float* x, int nw) {
#pragma unroll
    for (int i = 0; i < nw; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// this lane's EPL elements of a row; `vec` when the row is whole and
// aligned for word loads, else element by element with the hd guard
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* row, int lane, int hd,
                                         bool vec, float (&x)[EPL]) {
  constexpr int kNW = EPL / Elem<T>::kPerWord;
  if constexpr (kNW >= 1) {
    if (vec) {
      uint32_t w[kNW];
      load_words<kNW>(row + lane * EPL, w);
      Elem<T>::words_to_f(w, x, kNW);
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) {
    const int d = lane * EPL + e;
    x[e] = d < hd ? Elem<T>::get(row, d) : 0.0f;
  }
}

template <typename T, int HD, int GMAX>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc,
                    const uint8_t* __restrict__ valid, T* __restrict__ o,
                    int W, int K, int G, int n_grp, int gs, int hd,
                    float sqrt_hd, float softcap, int vec_ok) {
  constexpr int EPL = HD / 32;
  __shared__ float s_m[kWarps][GMAX];
  __shared__ float s_l[kWarps][GMAX];
  __shared__ float s_acc[kWarps][GMAX][HD];

  const int grp = blockIdx.x % n_grp;
  const int kvh = blockIdx.x / n_grp % K;
  const int b = blockIdx.x / n_grp / K;
  const int g0 = grp * gs;             // the block's first query head of kvh
  const int Gb = min(gs, G - g0);      // and its number of them (<= GMAX)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int H = K * G;
  const bool vec = vec_ok != 0;

  float qv[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[g][e] = 0.0f;
    if (g < Gb) {
      load_row<T, EPL>(q + ((long long)b * H + kvh * G + g0 + g) * hd, lane,
                       hd, vec, qv[g]);
    }
  }

  const uint8_t* vrow_ok = valid + (long long)b * W;
  const long long row_stride = (long long)K * hd;
  const T* kbase = kc + (long long)b * W * row_stride + (long long)kvh * hd;
  const T* vbase = vc + (long long)b * W * row_stride + (long long)kvh * hd;

  // one run's kRows slots: load k (and v) where valid (zeros elsewhere)
  auto load_run = [&](int s0, bool with_v, bool (&ok)[kRows],
                      float (&kx)[kRows][EPL], float (&vx)[kRows][EPL]) {
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int s = s0 + u;
      ok[u] = s < W && vrow_ok[s] != 0;
#pragma unroll
      for (int e = 0; e < EPL; ++e) kx[u][e] = vx[u][e] = 0.0f;
      if (ok[u]) {
        load_row<T, EPL>(kbase + s * row_stride, lane, hd, vec, kx[u]);
        if (with_v)
          load_row<T, EPL>(vbase + s * row_stride, lane, hd, vec, vx[u]);
      }
    }
  };
  // the run's scores for every head, the same in every lane: all kRows x
  // GMAX dot products are reduced across the warp together, so their
  // shuffles overlap instead of waiting on each other
  auto run_scores = [&](const float (&kx)[kRows][EPL],
                        float (&sc)[kRows][GMAX]) {
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qv[g][e], kx[u][e], d);
        sc[u][g] = d;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], o);
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float x = Elem<T>::round(sc[u][g]) / sqrt_hd;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        sc[u][g] = x;
      }
  };

  // pass 1: each warp's running max and sum of exponentials per head
  float m[GMAX], l[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
  }
  for (int s0 = warp * kRows; s0 < W; s0 += kWarps * kRows) {
    float kx[kRows][EPL], vx[kRows][EPL], sc[kRows][GMAX];
    bool ok[kRows];
    load_run(s0, false, ok, kx, vx);
    run_scores(kx, sc);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (!ok[u]) continue;           // uniform across the warp
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float m_new = fmaxf(m[g], sc[u][g]);
        l[g] = l[g] * expf(m[g] - m_new) + expf(sc[u][g] - m_new);
        m[g] = m_new;
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  // the block's max and sum per head (a warp with no slot adds 0)
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][g]);
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum = fmaf(s_l[w][g], expf(s_m[w][g] - mx), sum);
    m[g] = mx;
    l[g] = sum;
  }

  // pass 2: the rounded weights times v
  float acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.0f;
  for (int s0 = warp * kRows; s0 < W; s0 += kWarps * kRows) {
    float kx[kRows][EPL], vx[kRows][EPL], sc[kRows][GMAX];
    bool ok[kRows];
    load_run(s0, true, ok, kx, vx);
    run_scores(kx, sc);
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (!ok[u]) continue;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        const float w = Elem<T>::round(expf(sc[u][g] - m[g]) / l[g]);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(w, vx[u][e], acc[g][e]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane * EPL + e] = acc[g][e];
  __syncthreads();

  for (int idx = threadIdx.x; idx < Gb * hd; idx += kThreads) {
    const int g = idx / hd, dd = idx % hd;
    float A = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) A += s_acc[w][g][dd];
    // l is 0 only when no slot is valid: then every accumulator is 0
    Elem<T>::put(o + ((long long)b * H + kvh * G + g0 + g) * hd + dd, A);
  }
}

template <typename T, int HD, int GMAX>
int launch(const void* q, const void* kc, const void* vc, const void* valid,
           void* o, int B, int W, int K, int G, int n_grp, int gs, int hd,
           float softcap, int vec_ok, cudaStream_t stream) {
  flash_decode_kernel<T, HD, GMAX><<<B * K * n_grp, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const uint8_t*>(valid),
      static_cast<T*>(o), W, K, G, n_grp, gs, hd, sqrtf((float)hd), softcap,
      vec_ok);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* kc, const void* vc,
             const void* valid, void* o, int B, int W, int K, int G, int hd,
             float softcap, int vec_ok, cudaStream_t s) {
  // A thread holds GMAX * hd / 32 accumulators and as many query values:
  // at most 32 of each, so GMAX is 8 up to hd 128 and 4 at hd 256.  The G
  // query heads of a kv head are split into n_grp groups of gs <= GMAX
  // heads, one block each.
  const int gmax = hd <= 128 ? 8 : 4;
  const int n_grp = (G + gmax - 1) / gmax;
  const int gs = (G + n_grp - 1) / n_grp;
#define REPRO_FD_CASE(HDM, GM)                                            \
  if (hd <= HDM && gs <= GM)                                              \
    return launch<T, HDM, GM>(q, kc, vc, valid, o, B, W, K, G, n_grp, gs, \
                              hd, softcap, vec_ok && hd == HDM, s);
  REPRO_FD_CASE(64, 4)
  REPRO_FD_CASE(64, 8)
  REPRO_FD_CASE(128, 4)
  REPRO_FD_CASE(128, 8)
  REPRO_FD_CASE(256, 4)
#undef REPRO_FD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, 1, H, hd) and o contiguous; caches (B, W, K, hd) contiguous; valid
// (B, W) bytes (0 or 1).  dtype: 0 float32, 1 bfloat16.  vec_ok: every
// pointer is 16-byte aligned (the wrapper checks), so whole rows may be
// read with vector loads.
extern "C" int flash_decode_launch(const void* q, const void* kc,
                                   const void* vc, const void* valid, void* o,
                                   int B, int W, int K, int H, int hd,
                                   int dtype, float softcap, int vec_ok,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || W < 1 || K < 1 || H < 1 || H % K != 0 || hd < 1)
    return cudaErrorInvalidValue;
  const int G = H / K;
  if (dtype == 0)
    return dispatch<float>(q, kc, vc, valid, o, B, W, K, G, hd, softcap,
                           vec_ok, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, kc, vc, valid, o, B, W, K, G, hd,
                                   softcap, vec_ok, s);
  return cudaErrorInvalidValue;
}
