// The whole DDIM reverse process over the plain token-concat denoiser in one
// launch, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `seeme_tpu/ops/denoiser_fused.py::ddim_fused` with
// md_trans=False (`_fused_kernel_factory` -> `denoiser_apply_pure`'s
// token-concat branch, `_encoder_layer` / `_mha_1head`), the text-to-motion
// sampler. Per step and per sample, the token sequence [x; time; cond_0..NC-1]
// (positional rows 0..S-1 added, S = NC + 2) runs the U-skip stack of
// post-norm encoder layers: q/k/v of every token row, single-head attention
// over the S tokens of the same sample (scale 1/sqrt(D)), out_proj, residual,
// LayerNorm, Linear -> exact-erf GELU -> Linear, residual, LayerNorm; each
// output layer after its skip_linear over [h; skip]. Then the final LayerNorm
// of token 0, the classifier-free-guidance mix eps = u + g (c - u) when
// guidance > 1, and the eta=0 DDIM update
//   x0 = (z - sqrt(1 - a_t) eps) / sqrt(a_t),  z' = sqrt(a_prev) x0 + sqrt(1 - a_prev) eps.
// The time and condition rows attend to x, so every row of every sample runs
// every layer every step. The condition projection relu -> emb_proj and every
// step's time token (the sinusoid at the text width, then the MLP) are
// computed outside in PyTorch, once per window, with their positional rows.
//
// The TPU kernel's block-diagonal (B*S)^2 masked attention matmul was a
// Mosaic workaround; here attention loops within a sample. Its tanh GELU was
// too (Mosaic has no erf); here GELU is exact, as in the flax `Denoiser`.
//
// What bounds it on the H100: latency. At batch 64 and guidance 7.5 a step is
// 384 token rows through 5 layers of dependent small products (about 0.66
// MFLOP per row per layer, 73 GFLOP per call with the skips), which the FMA
// units would finish in about 1.1 ms, while the f32 weights (about 7.6 MB,
// read every step) sit in the 50 MB L2.
//
// This first design gives each CTA of 512 threads one sample: its S token
// rows, and under CFG also the S rows of its uncond twin, so the mix needs no
// other CTA (up to 20 rows). The rows' activations stay in shared memory; each
// product streams its weight matrix from L2 as in `ddim_md.cu`, in passes of
// up to 8 rows. Every CTA re-reads all weights every step, so the kernel is
// bound by each SM's L2 read rate; bf16 weights on wgmma and CTA clusters
// that share one weight read are the next steps.

#include <algorithm>

#include "ddim_common.cuh"

namespace {

constexpr int D = 256;     // latent width
constexpr int RC = 8;      // rows per pass of a dense product
constexpr int MAX_NC = 8;  // condition tokens

// Order of the weight pointers of one encoder layer in the pointer table; every
// weight is (in, out) row-major. After num_layers such groups come the
// skip_linear weight/bias pairs, the final norm's scale/bias and query_pos row 0.
enum { WQ, BQ, WK, BK, WV, BV, WO, BO, LN1G, LN1B, W1, B1, W2, B2, LN2G, LN2B, PER_LAYER };

struct Smem {
  float *red, *z, *e, *x, *q, *k, *hid, *skip, *lg;
};

// One post-norm GELU encoder layer over the CTA's R token rows, which are
// R / S groups (uncond, cond) of one sample's S tokens; attention stays within
// a group. m.hid holds v during attention, then the FFN's hidden rows.
__device__ void encoder_layer(const float* const* P, Smem& m, int R, int S, int FF) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* v = m.hid;
  dense<RC>(m.x, D, D, P[WQ], P[BQ], D, m.q, D, m.red, ACT_NONE, R);
  dense<RC>(m.x, D, D, P[WK], P[BK], D, m.k, D, m.red, ACT_NONE, R);
  dense<RC>(m.x, D, D, P[WV], P[BV], D, v, D, m.red, ACT_NONE, R);
  const float scale = rsqrtf((float)D);
  for (int p = warp; p < R * S; p += NWARP) {
    const int r = p / S, j = p - r * S;
    const float d = dot_warp(m.q + r * D, m.k + (r - r % S + j) * D, D);
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
    const float* vg = v + (r - r % S) * D + c;
    float o = 0.f;
    for (int j = 0; j < S; ++j) o = fmaf(a[j], vg[j * D], o);
    m.q[i] = o;
  }
  __syncthreads();
  dense<RC>(m.q, D, D, P[WO], P[BO], D, m.k, D, m.red, ACT_NONE, R);
  for (int i = tid; i < R * D; i += NT) m.k[i] += m.x[i];
  __syncthreads();
  layernorm(m.k, m.x, D, P[LN1G], P[LN1B], R);
  dense<RC>(m.x, D, D, P[W1], P[B1], FF, m.hid, FF, m.red, ACT_GELU, R);
  dense<RC>(m.hid, FF, FF, P[W2], P[B2], D, m.k, D, m.red, ACT_NONE, R);
  for (int i = tid; i < R * D; i += NT) m.k[i] += m.x[i];
  __syncthreads();
  layernorm(m.k, m.x, D, P[LN2G], P[LN2B], R);
}

__global__ void __launch_bounds__(NT, 1)
ddim_tok_t1_kernel(const float* __restrict__ z0, float* __restrict__ z_out,
                   const float* __restrict__ cond_in, const float* __restrict__ time_in,
                   const float* const* __restrict__ P, const float* __restrict__ acp_t,
                   const float* __restrict__ acp_prev, int B, int NC, int FF, int L, int steps,
                   float guidance, int cfg) {
  const int nb = (L - 1) / 2, S = NC + 2, H = cfg ? 2 : 1, R = H * S;
  const int s = blockIdx.x;  // the CTA's sample
  const int HW = max(FF, 2 * D);
  extern __shared__ __align__(16) float smem[];
  Smem m;
  m.red = smem;
  m.z = m.red + 4 * NT * RC;
  m.e = m.z + D;
  m.x = m.e + 2 * D;
  m.q = m.x + R * D;
  m.k = m.q + R * D;
  m.hid = m.k + R * D;
  m.skip = m.hid + R * HW;
  m.lg = m.skip + nb * R * D;

  for (int i = threadIdx.x; i < D; i += NT) m.z[i] = z0[(size_t)s * D + i];
  __syncthreads();
  const float* const* G = P + L * PER_LAYER;  // skip linears, final norm, pe row 0
  const float* pe0 = G[2 * nb + 2];
  for (int it = 0; it < steps; ++it) {
    // rows h * S + j: [x; time; cond] of group h (0 = uncond under CFG)
    for (int i = threadIdx.x; i < R * D; i += NT) {
      const int r = i / D, c = i - r * D, h = r / S, j = r - h * S;
      float val;
      if (j == 0) {
        val = m.z[c] + pe0[c];
      } else if (j == 1) {
        val = time_in[(size_t)it * D + c];
      } else {
        const int row = h ? B + s : s;
        val = cond_in[((size_t)row * NC + j - 2) * D + c];
      }
      m.x[i] = val;
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      if (l > nb) {  // output block j: skip_linear over [x; skip of input block nb-1-j]
        const int j = l - nb - 1;
        const float* sk = m.skip + (nb - 1 - j) * R * D;
        for (int i = threadIdx.x; i < R * D; i += NT) {
          const int r = i / D, c = i - r * D;
          m.hid[r * 2 * D + c] = m.x[i];
          m.hid[r * 2 * D + D + c] = sk[i];
        }
        __syncthreads();
        dense<RC>(m.hid, 2 * D, 2 * D, G[2 * j], G[2 * j + 1], D, m.x, D, m.red, ACT_NONE, R);
      }
      encoder_layer(P + l * PER_LAYER, m, R, S, FF);
      if (l < nb) {
        for (int i = threadIdx.x; i < R * D; i += NT) m.skip[l * R * D + i] = m.x[i];
        __syncthreads();
      }
    }
    // final LayerNorm of each group's token 0: the eps rows
    for (int i = threadIdx.x; i < H * D; i += NT) m.q[i] = m.x[(i / D) * S * D + i % D];
    __syncthreads();
    layernorm(m.q, m.e, D, G[2 * nb], G[2 * nb + 1], H);
    const float at = acp_t[it], ap = acp_prev[it];
    const float c_eps = sqrtf(1.f - at), inv_sa = 1.f / sqrtf(at);
    const float sa_prev = sqrtf(ap), c_prev = sqrtf(1.f - ap);
    for (int i = threadIdx.x; i < D; i += NT) {
      float e = m.e[i];
      if (cfg) e = e + guidance * (m.e[D + i] - e);
      const float x0 = (m.z[i] - c_eps * e) * inv_sa;
      m.z[i] = sa_prev * x0 + c_prev * e;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < D; i += NT) z_out[(size_t)s * D + i] = m.z[i];
}

}  // namespace

// z0, z_out (B, D); cond_in (Bc, NC, D), the projected condition tokens plus
// their positional rows 2..NC+1, Bc = 2B rows [uncond; cond] when cfg != 0;
// time_in (steps, D), every step's time token plus positional row 1;
// wptr: device array of (L * 16 + 2 * ((L - 1) / 2) + 3) weight pointers;
// acp_t, acp_prev (steps,). D = 256, 1 <= NC <= 8.
extern "C" int ddim_tok_t1(const float* z0, float* z_out, const float* cond_in,
                           const float* time_in, const void* wptr, const float* acp_t,
                           const float* acp_prev, int B, int NC, int FF, int L, int steps,
                           float guidance, int cfg, void* stream) {
  if (FF % 4 != 0 || FF / 4 > NT || NT % (FF / 4) != 0 || FF > 2 * D) return cudaErrorInvalidValue;
  if (L % 2 != 1 || NC < 1 || NC > MAX_NC || B < 1 || steps < 1) return cudaErrorInvalidValue;
  const int nb = (L - 1) / 2, S = NC + 2, R = (cfg ? 2 : 1) * S;
  const int HW = std::max(FF, 2 * D);
  const int lg = (R * S + 3) / 4 * 4;
  const size_t smem =
      (size_t)(4 * NT * RC + 3 * D + 3 * R * D + R * HW + nb * R * D + lg) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ddim_tok_t1_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ddim_tok_t1_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      z0, z_out, cond_in, time_in, static_cast<const float* const*>(wptr), acp_t, acp_prev, B,
      NC, FF, L, steps, guidance, cfg);
  return cudaGetLastError();
}
