// The whole DDIM reverse process over the MD-transformer denoiser in one launch,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `seeme_tpu/ops/denoiser_fused.py::ddim_fused`
// (`_fused_kernel_factory` -> `_md_layer_t1`), md_trans=True with one latent
// token (T=1). Per step, for every latent row: the U-skip stack of MD layers
// (self-attention of the latent row over [latent; cond tokens; time token],
// post-norm ReLU FFN, linear cross-attention, stylized GELU FFN), the
// skip_linears and the final LayerNorm, the classifier-free-guidance mix
// eps = u + g (c - u) when guidance > 1, and the eta=0 DDIM update
//   x0 = (z - sqrt(1 - a_t) eps) / sqrt(a_t),  z' = sqrt(a_prev) x0 + sqrt(1 - a_prev) eps.
// The step-invariant pieces (condition k/v, softmaxed cross-attention key and
// value, and the per-step time-token rows) are computed outside in PyTorch, as
// `ddim_fused_grid` does in XLA. GELU is the exact erf form of the flax
// `Denoiser`; the Pallas kernel used tanh only because Mosaic has no erf.
//
// What bounds it on the H100: latency. At batch 64 a step is 5 layers of
// dependent small products (M = 64 or 128 rows, K and N of 128..1024); about
// 11 MFLOP per row per step, 35 GFLOP per call at guidance 1, which the FMA
// units would finish in about half a millisecond, while the weights (about
// 22 MB in f32 read per step) sit in the 50 MB L2 after the first step.
//
// This first design gives each CTA of 512 threads 4 latent rows (4 samples,
// or under CFG 2 samples with their uncond and cond rows, so the mix needs no
// other CTA) for all steps and layers. The rows' activations stay in shared
// memory; each product streams its f32 weight matrix from L2 with float4
// loads, 8 in flight per thread, splitting K across thread groups that meet
// in shared memory. Every CTA re-reads all weights every step, so the kernel
// is bound by each SM's L2 read rate; bf16 weights, wgmma and CTA clusters
// that share one weight read are the next steps.

#include <algorithm>
#include <initializer_list>

#include "ddim_common.cuh"

namespace {

constexpr int R = 4;  // latent rows per CTA

// Order of the weight pointers of one MD layer in the pointer table; every
// weight is (in, out) row-major. After num_layers such groups come the
// skip_linear weight/bias pairs, the final norm's scale/bias and query_pos row 0.
enum {
  WQ, BQ, WK, BK, WV, BV, WO, BO, LN1G, LN1B, W1, B1, W2, B2, LN2G, LN2B,
  CANG, CANB, WQC, BQC, CASG, CASB, CAOW, CAOB,
  WF1, BF1, WF2, BF2, FSG, FSB, FOW, FOB, PER_LAYER
};

// In-place softmax over D per row, one warp per row.
__device__ void softmax_rows(float* x, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NWARP) {
    float* row = x + r * D;
    float m = -INFINITY;
    for (int c = lane; c < D; c += 32) m = fmaxf(m, row[c]);
    m = warp_max(m);
    float s = 0.f;
    for (int c = lane; c < D; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    const float inv = 1.f / warp_sum(s);
    for (int c = lane; c < D; c += 32) row[c] *= inv;
  }
  __syncthreads();
}

struct Smem {
  float *red, *z, *x, *q, *k, *v, *o, *t, *skip, *lg;
};

// x += out_linear(silu(LayerNorm(h) * (1 + scale) + shift)), the stylization
// block with its emb_linear row (scale | shift) precomputed. Clobbers h, o.
__device__ void stylize_add(const float* const* P, int ng, int nb_, int ow, int ob,
                            const float* __restrict__ eo, float* h, Smem& m, int D) {
  layernorm(h, m.o, D, P[ng], P[nb_], R);
  for (int i = threadIdx.x; i < R * D; i += NT) {
    const int c = i % D;
    m.o[i] = silu(m.o[i] * (1.f + eo[c]) + eo[D + c]);
  }
  __syncthreads();
  dense<R>(m.o, D, D, P[ow], P[ob], D, h, D, m.red, ACT_NONE, R);
  for (int i = threadIdx.x; i < R * D; i += NT) m.x[i] += h[i];
  __syncthreads();
}

// One MD layer for the CTA's rows, T=1 (`_md_layer_t1`). cond[r] points at row
// r's (NC, 4, D) condition invariants [k, v, ca_key, ca_value]; step at this
// layer's (6, D) time-token row [k, v, ca scale, ca shift, ffn scale, ffn shift].
__device__ void md_layer(const float* const* P, const float* const* cond,
                         const float* __restrict__ step, Smem& m, int D, int F1, int FF,
                         int NC) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int S = NC + 2;
  // self-attention of the latent row over [latent; cond; time]
  dense<R>(m.x, D, D, P[WQ], P[BQ], D, m.q, D, m.red, ACT_NONE, R);
  dense<R>(m.x, D, D, P[WK], P[BK], D, m.k, D, m.red, ACT_NONE, R);
  dense<R>(m.x, D, D, P[WV], P[BV], D, m.v, D, m.red, ACT_NONE, R);
  const float scale = rsqrtf((float)D);
  for (int p = warp; p < R * S; p += NWARP) {
    const int r = p / S, j = p - r * S;
    const float* key = j == 0 ? m.k + r * D : (j <= NC ? cond[r] + (j - 1) * 4 * D : step);
    const float d = dot_warp(m.q + r * D, key, D);
    if (lane == 0) m.lg[p] = d * scale;
  }
  __syncthreads();
  if (tid < R) {
    float* l = m.lg + tid * S;
    float mx = l[0];
    for (int j = 1; j < S; ++j) mx = fmaxf(mx, l[j]);
    float sum = 0.f;
    for (int j = 0; j < S; ++j) {
      l[j] = expf(l[j] - mx);
      sum += l[j];
    }
    for (int j = 0; j < S; ++j) l[j] /= sum;
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, c = i - r * D;
    const float* a = m.lg + r * S;
    float val = a[0] * m.v[i];
    for (int n = 0; n < NC; ++n) val = fmaf(a[1 + n], cond[r][(n * 4 + 1) * D + c], val);
    m.t[i] = fmaf(a[NC + 1], step[D + c], val);
  }
  __syncthreads();
  dense<R>(m.t, D, D, P[WO], P[BO], D, m.o, D, m.red, ACT_NONE, R);
  for (int i = tid; i < R * D; i += NT) m.o[i] += m.x[i];
  __syncthreads();
  layernorm(m.o, m.x, D, P[LN1G], P[LN1B], R);
  // post-norm ReLU FFN of the self-attention block
  dense<R>(m.x, D, D, P[W1], P[B1], F1, m.t, F1, m.red, ACT_RELU, R);
  dense<R>(m.t, F1, F1, P[W2], P[B2], D, m.o, D, m.red, ACT_NONE, R);
  for (int i = tid; i < R * D; i += NT) m.o[i] += m.x[i];
  __syncthreads();
  layernorm(m.o, m.x, D, P[LN2G], P[LN2B], R);
  // linear cross-attention: softmax(query) . softmax_tokens(key) -> value mix
  layernorm(m.x, m.o, D, P[CANG], P[CANB], R);
  dense<R>(m.o, D, D, P[WQC], P[BQC], D, m.q, D, m.red, ACT_NONE, R);
  softmax_rows(m.q, D);
  for (int p = warp; p < R * NC; p += NWARP) {
    const int r = p / NC, n = p - r * NC;
    const float d = dot_warp(m.q + r * D, cond[r] + (n * 4 + 2) * D, D);
    if (lane == 0) m.lg[r * S + n] = d;
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, c = i - r * D;
    float y = 0.f;
    for (int n = 0; n < NC; ++n) y = fmaf(m.lg[r * S + n], cond[r][(n * 4 + 3) * D + c], y);
    m.t[i] = y;
  }
  __syncthreads();
  stylize_add(P, CASG, CASB, CAOW, CAOB, step + 2 * D, m.t, m, D);
  // stylized GELU FFN
  dense<R>(m.x, D, D, P[WF1], P[BF1], FF, m.t, FF, m.red, ACT_GELU, R);
  dense<R>(m.t, FF, FF, P[WF2], P[BF2], D, m.k, D, m.red, ACT_NONE, R);
  stylize_add(P, FSG, FSB, FOW, FOB, step + 4 * D, m.k, m, D);
}

__global__ void __launch_bounds__(NT, 1)
ddim_md_t1_kernel(const float* __restrict__ z0, float* __restrict__ z_out,
                  const float* __restrict__ inv_cond, const float* __restrict__ inv_step,
                  const float* const* __restrict__ P, const float* __restrict__ acp_t,
                  const float* __restrict__ acp_prev, int B, int Bc, int NC, int D, int F1,
                  int FF, int L, int steps, float guidance, int cfg) {
  const int nb = (L - 1) / 2;
  const int S = cfg ? R / 2 : R;  // samples per CTA
  const int s0 = blockIdx.x * S;
  const int TW = max(max(F1, FF), 2 * D);
  extern __shared__ __align__(16) float smem[];
  Smem m;
  m.red = smem;
  m.z = m.red + 4 * NT * R;
  m.x = m.z + R * D;
  m.q = m.x + R * D;
  m.k = m.q + R * D;
  m.v = m.k + R * D;
  m.o = m.v + R * D;
  m.t = m.o + R * D;
  m.skip = m.t + R * TW;
  m.lg = m.skip + nb * R * D;

  // row r: sample s0 + r % S; under CFG rows [0, S) are uncond, [S, 2S) cond
  const float* cond_row[R];
  bool valid[R];
  for (int r = 0; r < R; ++r) {
    const int s = s0 + r % S;
    valid[r] = s < B;
    const int cr = !valid[r] ? 0 : (cfg && r >= S ? B + s : s);
    cond_row[r] = inv_cond + (size_t)cr * NC * 4 * D;  // + layer offset below
  }
  for (int i = threadIdx.x; i < S * D; i += NT) {
    const int s = s0 + i / D;
    m.z[i] = s < B ? z0[(size_t)s * D + i % D] : 0.f;
  }
  __syncthreads();

  const float* const* G = P + L * PER_LAYER;  // skip linears, final norm, pe row
  const size_t layer_cond = (size_t)Bc * NC * 4 * D;
  for (int it = 0; it < steps; ++it) {
    for (int i = threadIdx.x; i < R * D; i += NT)
      m.x[i] = m.z[(i / D % S) * D + i % D] + G[2 * nb + 2][i % D];
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      if (l > nb) {  // output block j: skip_linear over [x; skip of input block nb-1-j]
        const int j = l - nb - 1;
        const float* sk = m.skip + (nb - 1 - j) * R * D;
        for (int i = threadIdx.x; i < R * D; i += NT) {
          const int r = i / D, c = i - r * D;
          m.t[r * 2 * D + c] = m.x[i];
          m.t[r * 2 * D + D + c] = sk[i];
        }
        __syncthreads();
        dense<R>(m.t, 2 * D, 2 * D, G[2 * j], G[2 * j + 1], D, m.x, D, m.red, ACT_NONE, R);
      }
      const float* cond[R];
      for (int r = 0; r < R; ++r) cond[r] = cond_row[r] + l * layer_cond;
      md_layer(P + l * PER_LAYER, cond, inv_step + ((size_t)l * steps + it) * 6 * D, m, D, F1,
               FF, NC);
      if (l < nb) {
        for (int i = threadIdx.x; i < R * D; i += NT) m.skip[l * R * D + i] = m.x[i];
        __syncthreads();
      }
    }
    layernorm(m.x, m.o, D, G[2 * nb], G[2 * nb + 1], R);  // eps rows
    const float at = acp_t[it], ap = acp_prev[it];
    const float c_eps = sqrtf(1.f - at), inv_sa = 1.f / sqrtf(at);
    const float sa_prev = sqrtf(ap), c_prev = sqrtf(1.f - ap);
    for (int i = threadIdx.x; i < S * D; i += NT) {
      float e = m.o[i];
      if (cfg) e = e + guidance * (m.o[S * D + i] - e);
      const float x0 = (m.z[i] - c_eps * e) * inv_sa;
      m.z[i] = sa_prev * x0 + c_prev * e;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < S * D; i += NT) {
    const int s = s0 + i / D;
    if (s < B) z_out[(size_t)s * D + i % D] = m.z[i];
  }
}

}  // namespace

// z0, z_out (B, D); inv_cond (L, Bc, NC, 4, D); inv_step (L, steps, 6, D);
// wptr: device array of (L * 32 + 2 * ((L - 1) / 2) + 3) weight pointers;
// acp_t, acp_prev (steps,). cfg != 0: Bc = 2B rows [uncond; cond].
extern "C" int ddim_md_t1(const float* z0, float* z_out, const float* inv_cond,
                          const float* inv_step, const void* wptr, const float* acp_t,
                          const float* acp_prev, int B, int Bc, int NC, int D, int F1, int FF,
                          int L, int steps, float guidance, int cfg, void* stream) {
  for (int n : {D, F1, FF})
    if (n % 4 != 0 || n / 4 > NT || NT % (n / 4) != 0) return cudaErrorInvalidValue;
  if (L % 2 != 1 || NC < 1 || B < 1) return cudaErrorInvalidValue;
  const int nb = (L - 1) / 2;
  const int S = cfg ? R / 2 : R;
  const int TW = std::max(std::max(F1, FF), 2 * D);
  const int lg = (R * (NC + 2) + 3) / 4 * 4;
  const size_t smem = (size_t)(4 * NT * R + 6 * R * D + R * TW + nb * R * D + lg) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ddim_md_t1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (B + S - 1) / S;
  ddim_md_t1_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      z0, z_out, inv_cond, inv_step, static_cast<const float* const*>(wptr), acp_t, acp_prev, B,
      Bc, NC, D, F1, FF, L, steps, guidance, cfg);
  return cudaGetLastError();
}
