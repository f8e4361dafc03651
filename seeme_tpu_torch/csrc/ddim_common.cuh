// Device helpers shared by the two DDIM kernels, `ddim_md.cu` and `ddim_tok.cu`:
// the small dense products over a CTA's rows (weights streamed from L2), row
// LayerNorm and warp reductions. Every CTA has NT threads. A product runs in
// passes of up to RC rows, each compiled for its exact row count, since the
// token kernel's CTAs hold 3 to 20 rows.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;

enum { ACT_NONE, ACT_RELU, ACT_GELU };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// GELU is the exact erf form of the flax modules.
__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.f);
  if (act == ACT_GELU) return 0.5f * v * (1.f + erff(v * 0.7071067811865475f));
  return v;
}

// out[r][c] = act(sum_k A[r][k] W[k][c] + bias[c]) for the NR rows r < NR.
// A (NR, K) in shared memory with row stride lda; W (K, N) row-major in device
// memory. Thread t takes column quad t % (N/4) and the K slice t / (N/4) of
// NT / (N/4) interleaved slices, with 8 float4 weight loads in flight; partials
// meet in red (4 * NT * NR floats).
template <int NR>
__device__ __forceinline__ void dense_pass(const float* A, int lda, int K,
                                           const float* __restrict__ W,
                                           const float* __restrict__ bias, int N, float* out,
                                           int ldo, float* red, int act) {
  const int nq = N >> 2, ks = NT / nq, tid = threadIdx.x;
  const int q = tid % nq, s = tid / nq;
  const float4* W4 = reinterpret_cast<const float4*>(W) + q;
  float acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  int k = s;
  for (; k + 7 * ks < K; k += 8 * ks) {
    float4 w[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) w[u] = __ldg(W4 + (size_t)(k + u * ks) * nq);
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float a = A[r * lda + k + u * ks];
        acc[r][0] = fmaf(a, w[u].x, acc[r][0]);
        acc[r][1] = fmaf(a, w[u].y, acc[r][1]);
        acc[r][2] = fmaf(a, w[u].z, acc[r][2]);
        acc[r][3] = fmaf(a, w[u].w, acc[r][3]);
      }
  }
  for (; k < K; k += ks) {
    const float4 w = __ldg(W4 + (size_t)k * nq);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float a = A[r * lda + k];
      acc[r][0] = fmaf(a, w.x, acc[r][0]);
      acc[r][1] = fmaf(a, w.y, acc[r][1]);
      acc[r][2] = fmaf(a, w.z, acc[r][2]);
      acc[r][3] = fmaf(a, w.w, acc[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
    *reinterpret_cast<float4*>(red + (s * NR + r) * N + 4 * q) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = tid; i < NR * N; i += NT) {
    const int r = i / N, c = i - r * N;
    float v = 0.f;
    for (int t = 0; t < ks; ++t) v += red[(t * NR + r) * N + c];
    out[r * ldo + c] = activate(v + bias[c], act);
  }
  __syncthreads();
}

// dense_pass<nr> for a row count known only at run time, 1 <= nr <= NR.
template <int NR>
__device__ __forceinline__ void dense_pass_n(int nr, const float* A, int lda, int K,
                                             const float* __restrict__ W,
                                             const float* __restrict__ bias, int N, float* out,
                                             int ldo, float* red, int act) {
  if constexpr (NR > 1) {
    if (nr < NR) {
      dense_pass_n<NR - 1>(nr, A, lda, K, W, bias, N, out, ldo, red, act);
      return;
    }
  }
  dense_pass<NR>(A, lda, K, W, bias, N, out, ldo, red, act);
}

// The dense product for rows r < R, in passes of up to RC rows (each pass
// streams W once); red holds 4 * NT * RC floats.
template <int RC>
__device__ void dense(const float* A, int lda, int K, const float* __restrict__ W,
                      const float* __restrict__ bias, int N, float* out, int ldo,
                      float* red, int act, int R) {
  for (int r0 = 0; r0 < R; r0 += RC)
    dense_pass_n<RC>(min(RC, R - r0), A + r0 * lda, lda, K, W, bias, N, out + r0 * ldo, ldo,
                     red, act);
}

// out = LayerNorm(in) * g + b over D for `rows` rows (eps 1e-5), one warp per
// row; in and out may alias.
__device__ void layernorm(const float* in, float* out, int D, const float* __restrict__ g,
                          const float* __restrict__ b, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += NWARP) {
    const float* x = in + r * D;
    float s = 0.f;
    for (int c = lane; c < D; c += 32) s += x[c];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float d = x[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / D + 1e-5f);
    for (int c = lane; c < D; c += 32) out[r * D + c] = (x[c] - mean) * inv * g[c] + b[c];
  }
  __syncthreads();
}

__device__ __forceinline__ float dot_warp(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int c = threadIdx.x & 31; c < D; c += 32) s = fmaf(a[c], b[c], s);
  return warp_sum(s);
}

}  // namespace
