// The whole DDIM reverse process over the plain token-concat denoiser in one
// launch, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `seeme_tpu/ops/denoiser_fused.py::ddim_fused` with
// md_trans=False (`_fused_kernel_factory` -> `denoiser_apply_pure`'s
// token-concat branch, `_encoder_layer` / `_mha_1head`), the text-to-motion
// sampler. Per step and per sample, the token sequence [x_0..T-1; time;
// cond_0..NC-1] (positional rows 0..S-1 added, S = T + 1 + NC) runs the U-skip stack of
// post-norm encoder layers: q/k/v of every token row, single-head attention
// over the S tokens of the same sample (scale 1/sqrt(D)), out_proj, residual,
// LayerNorm, Linear -> exact-erf GELU -> Linear, residual, LayerNorm; each
// output layer after its skip_linear over [h; skip]. Then the final LayerNorm
// of tokens 0..T-1, the classifier-free-guidance mix eps = u + g (c - u) when
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
// The design: a cluster of CLUSTER (8) CTAs of 512 threads carries spc whole
// samples through all steps and layers: all S token rows of each, and under
// CFG of its uncond twin too, at most MAX_ROWS (30) rows. spc is the fewest
// samples that let all of the batch's clusters run at once (15 clusters of 8
// on an H100: batch 64 runs 13 clusters of 5 samples, 30 rows under CFG with
// the text-to-motion model's one condition token). Each product is split by
// columns over the cluster (`cluster_dense` in ddim_common.cuh): a CTA
// streams its eighth of the weight matrix once per step for all of the
// cluster's rows and pushes its slice of the output (with the residual add,
// where there is one) into every CTA's shared memory; q, k and v share one
// exchange, and the skip_linear reads [x; skip] from its two buffers.
// Attention, the norms, the mix and the update are repeated in every CTA,
// one warp a row.
//
// The kernel is a template on the latent token count: TF = 1 is the T = 1
// specialisation (T a compile-time constant: every division by T folds
// away), TF = 0 takes T at run time. Each instance is built in a
// translation unit of its own (ddim_tok_t1.cu, ddim_tok.cu), so that nvcc
// compiles them side by side. At T = 10, one condition token and CFG a
// sample is 24 rows, so a cluster carries one sample and batch 64 runs in
// waves of the clusters that fit.
//
// What bounds it on the H100: at batch 64 and guidance 7.5 a step is 384
// token rows through 5 layers of dependent small products (about 0.66 MFLOP
// per row per layer, 73 GFLOP per call with the skips), which the FMA units
// would finish in about 1.1 ms; the f32 weights (about 7.6 MB per step) stay
// in the 50 MB L2. The FMAs are a small part of a CTA's time; most of it is
// its weight slice's dependent round trips from L2, then the pushes and the
// 22 cluster barriers of a step (PERF.md).

#pragma once

#include <algorithm>

#include "ddim_common.cuh"

namespace {

constexpr int D = 256;        // latent width
constexpr int MAX_NC = 8;     // condition tokens
constexpr int MAX_ROWS = DDIM_TOK_MAX_ROWS;  // token rows a cluster
constexpr int MAX_SPC = 8;    // samples a cluster

// Order of the weight pointers of one encoder layer in the pointer table; every
// weight is (in, out) row-major. After num_layers such groups come the
// skip_linear weight/bias pairs, the final norm's scale/bias and query_pos row 0.
enum { WQ, BQ, WK, BK, WV, BV, WO, BO, LN1G, LN1B, W1, B1, W2, B2, LN2G, LN2B, PER_LAYER };

struct Smem {
  float *red, *z, *e, *x, *q, *k, *hid, *skip, *lg;
};

// out = act(A W + b) (+ res) for the R rows, through the cluster.
__device__ void dense(const Operand& A, int K, const float* W, const float* b, int N,
                      float* out, float* red, int act, int R, const float* res = nullptr) {
  const Product p[1] = {{W, b, out, N, N, act, res}};
  cluster_dense(A, K, p, red, R);
}

constexpr int PL = D / 32;  // columns a lane holds of a row

// Single-head attention of each token row over the S tokens of its group
// (scale 1/sqrt(D)), from m.q, m.k and v into m.q; one warp a row. A warp
// reads only its own row of m.q before it writes it.
__device__ void attend(const Smem& m, const float* v, int R, int S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float scale = rsqrtf((float)D);
  for (int r = warp; r < R; r += NWARP) {
    const int g0 = r - r % S;  // the group's first row
    float* lg = m.lg + r * S;
    for (int j = 0; j < S; ++j) {
      const float d = dot_warp<D>(m.q + r * D, m.k + (g0 + j) * D);
      if (lane == 0) lg[j] = d * scale;
    }
    __syncwarp();
    float mx = lg[0];
    for (int j = 1; j < S; ++j) mx = fmaxf(mx, lg[j]);
    float sum = 0.f;
    for (int j = 0; j < S; ++j) sum += expf(lg[j] - mx);
    float o[PL] = {};
    for (int j = 0; j < S; ++j) {
      const float a = expf(lg[j] - mx) / sum;
#pragma unroll
      for (int i = 0; i < PL; ++i) o[i] = fmaf(a, v[(g0 + j) * D + lane + 32 * i], o[i]);
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) m.q[r * D + lane + 32 * i] = o[i];
    __syncwarp();
  }
  __syncthreads();
}

// One post-norm GELU encoder layer over the cluster's R token rows, which are
// R / S groups (a sample's uncond or cond half) of S tokens; attention stays
// within a group. m.hid holds v during attention, then the FFN's hidden rows.
// No product writes its own input (see cluster_dense); the residual adds
// ride on the products' pushes.
__device__ void encoder_layer(const float* const* P, Smem& m, int R, int S, int FF) {
  float* v = m.hid;
  const Product qkv[3] = {{P[WQ], P[BQ], m.q, D, D, ACT_NONE},
                          {P[WK], P[BK], m.k, D, D, ACT_NONE},
                          {P[WV], P[BV], v, D, D, ACT_NONE}};
  cluster_dense(rows_of(m.x, D), D, qkv, m.red, R);
  attend(m, v, R, S);
  dense(rows_of(m.q, D), D, P[WO], P[BO], D, m.k, m.red, ACT_NONE, R, m.x);
  layernorm<D>(m.k, m.x, P[LN1G], P[LN1B], R);
  dense(rows_of(m.x, D), D, P[W1], P[B1], FF, m.hid, m.red, ACT_GELU, R);
  dense(rows_of(m.hid, FF), FF, P[W2], P[B2], D, m.k, m.red, ACT_NONE, R, m.x);
  layernorm<D>(m.k, m.x, P[LN2G], P[LN2B], R);
}

// Floats of red for R rows: the widest partials of the kernel's products.
__host__ __device__ int red_size(int R, int FF) {
  const int a = red_floats(D, R), b = red_floats(FF, R);
  return a > b ? a : b;
}

// Shared-memory floats for the cluster's spc samples of T latent tokens, H
// halves of S rows each.
size_t smem_floats(int spc, int T, int H, int S, int FF, int L) {
  const int nb = (L - 1) / 2, R = spc * H * S;
  const int lg = (R * S + 3) / 4 * 4;
  return (size_t)red_size(R, FF) + spc * T * D + spc * H * T * D + 4 * R * D + nb * R * D + lg;
}

template <int TF>
__global__ void __launch_bounds__(NT, 1)
ddim_tok_kernel(const float* __restrict__ z0, float* __restrict__ z_out,
                const float* __restrict__ cond_in, const float* __restrict__ time_in,
                const float* const* __restrict__ P, const float* __restrict__ acp_t,
                const float* __restrict__ acp_prev, const float* __restrict__ pe, int B, int NC,
                int FF, int L, int steps, float guidance, int cfg, int spc, int T_) {
  const int T = TF ? TF : T_;
  const int nb = (L - 1) / 2, S = T + 1 + NC, H = cfg ? 2 : 1, R = spc * H * S;
  const int s0 = blockIdx.x / CLUSTER * spc;  // the cluster's first sample
  extern __shared__ __align__(16) float smem[];
  Smem m;
  m.red = smem;
  m.z = m.red + red_size(R, FF);
  m.e = m.z + spc * T * D;
  m.x = m.e + spc * H * T * D;
  m.q = m.x + R * D;
  m.k = m.q + R * D;
  m.hid = m.k + R * D;  // v (R x D), then the FFN's hidden rows (R x FF <= R x D)
  m.skip = m.hid + R * D;
  m.lg = m.skip + nb * R * D;

  // sample s0 + i past the batch end computes a copy of the last sample and
  // is never written out
  for (int i = threadIdx.x; i < spc * T * D; i += NT)
    m.z[i] = z0[(size_t)min(s0 + i / (T * D), B - 1) * T * D + i % (T * D)];
  __syncthreads();
  const float* const* G = P + L * PER_LAYER;  // skip linears, final norm, pe row 0
  const float* pe_rows = TF == 1 ? G[2 * nb + 2] : pe;  // (T, D) positional rows
  for (int it = 0; it < steps; ++it) {
    // row (i * H + h) * S + j: token j [x_0..T-1; time; cond] of half h (0 =
    // uncond under CFG) of the cluster's sample i
    for (int i = threadIdx.x; i < R * D; i += NT) {
      const int r = i / D, c = i - r * D, g = r / S, j = r - g * S, li = g / H, h = g - li * H;
      float val;
      if (j < T) {
        val = m.z[(li * T + j) * D + c] + pe_rows[j * D + c];
      } else if (j == T) {
        val = time_in[(size_t)it * D + c];
      } else {
        const int s = min(s0 + li, B - 1);
        const int row = h ? B + s : s;
        val = cond_in[((size_t)row * NC + j - T - 1) * D + c];
      }
      m.x[i] = val;
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      if (l > nb) {  // output block j: skip_linear over [x; skip of input block nb-1-j]
        const int j = l - nb - 1;
        const Operand xs{m.x, m.skip + (nb - 1 - j) * R * D, D, D, D};
        dense(xs, 2 * D, G[2 * j], G[2 * j + 1], D, m.q, m.red, ACT_NONE, R);
        float* x = m.q;  // the same swap in every CTA: the buffers keep their offsets
        m.q = m.x;
        m.x = x;
      }
      encoder_layer(P + l * PER_LAYER, m, R, S, FF);
      if (l < nb) {
        for (int i = threadIdx.x; i < R * D; i += NT) m.skip[l * R * D + i] = m.x[i];
        __syncthreads();
      }
    }
    // final LayerNorm of each half's tokens 0..T-1: the eps rows, T a half
    for (int i = threadIdx.x; i < spc * H * T * D; i += NT) {
      const int er = i / D, g = er / T;
      m.q[i] = m.x[(g * S + er - g * T) * D + i % D];
    }
    __syncthreads();
    layernorm<D>(m.q, m.e, G[2 * nb], G[2 * nb + 1], spc * H * T);
    const float at = acp_t[it], ap = acp_prev[it];
    const float c_eps = sqrtf(1.f - at), inv_sa = 1.f / sqrtf(at);
    const float sa_prev = sqrtf(ap), c_prev = sqrtf(1.f - ap);
    for (int i = threadIdx.x; i < spc * T * D; i += NT) {
      const int li = i / (T * D), c = i - li * T * D;
      const float* eu = m.e + li * H * T * D + c;
      float e = eu[0];
      if (cfg) e = e + guidance * (eu[T * D] - e);
      const float x0 = (m.z[i] - c_eps * e) * inv_sa;
      m.z[i] = sa_prev * x0 + c_prev * e;
    }
    __syncthreads();
  }
  if (blockIdx.x % CLUSTER == 0)  // every CTA of the cluster holds the same z
    for (int i = threadIdx.x; i < spc * T * D; i += NT) {
      const int s = s0 + i / (T * D);
      if (s < B) z_out[(size_t)s0 * T * D + i] = m.z[i];
    }
}

// The shapes the kernel takes: both product widths split over the cluster.
bool takes(int NC, int FF, int L, int B, int T) {
  return splits(D) && splits(FF) && FF <= D && L % 2 == 1 && NC >= 1 && NC <= MAX_NC && B >= 1 &&
         T >= 1;
}

// The launch of instance TF for B samples of T latent and NC condition
// tokens (cfg: two halves each): samples a cluster so that all clusters fit
// on the card at once, within MAX_ROWS token rows, MAX_SPC samples and,
// past one token, the card's shared memory a CTA.
template <int TF>
struct Plan {
  int spc;
  size_t smem;
  int err;
  Plan(int B, int T, int NC, int FF, int L, int cfg) {
    const int H = cfg ? 2 : 1, S = T + 1 + NC;
    spc = 0;
    smem = 0;
    if (H * S > MAX_ROWS) {
      err = REFUSE_TOKEN_ROWS;
      return;
    }
    int most = std::min(MAX_SPC, MAX_ROWS / (H * S));
    if (T > 1) {
      int dev = 0, cap = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      while (most > 0 && smem_floats(most, T, H, S, FF, L) * sizeof(float) > (size_t)cap) --most;
    }
    if (most == 0) {
      err = REFUSE_SAMPLE_SMEM;
      return;
    }
    int fit = 0;
    err = ClusterLaunch(1, smem_floats(most, T, H, S, FF, L) * sizeof(float), nullptr)
              .active(&ddim_tok_kernel<TF>, &fit);
    spc = samples_per_cluster(B, fit, most);
    smem = smem_floats(spc, T, H, S, FF, L) * sizeof(float);
  }
  int clusters(int B) const { return (B + spc - 1) / spc; }
};

template <int TF>
int launch(const float* z0, float* z_out, const float* cond_in, const float* time_in,
           const void* wptr, const float* acp_t, const float* acp_prev, const float* pe, int B,
           int NC, int FF, int L, int steps, int T, float guidance, int cfg, void* stream) {
  const Plan<TF> plan(B, T, NC, FF, L, cfg);
  if (plan.err != cudaSuccess) return plan.err;
  const ClusterLaunch launch(plan.clusters(B), plan.smem, stream);
  cudaError_t err = launch.setup(&ddim_tok_kernel<TF>);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&launch.config, &ddim_tok_kernel<TF>, z0, z_out, cond_in, time_in,
                           static_cast<const float* const*>(wptr), acp_t, acp_prev, pe, B, NC, FF,
                           L, steps, guidance, cfg, plan.spc, T);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch `launch<TF>` makes, without launching: info[5] = CTAs per
// cluster, CTAs in the grid, clusters that fit at once, dynamic shared
// memory bytes per CTA, samples a cluster.
template <int TF>
int describe(int B, int T, int NC, int FF, int L, int cfg, int* info) {
  const Plan<TF> plan(B, T, NC, FF, L, cfg);
  if (plan.err != cudaSuccess) return plan.err;
  info[4] = plan.spc;
  return ClusterLaunch(plan.clusters(B), plan.smem, nullptr).describe(&ddim_tok_kernel<TF>, info);
}

}  // namespace
