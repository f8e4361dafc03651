// The whole DDIM reverse process over the MD-transformer denoiser in one launch,
// CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `seeme_tpu/ops/denoiser_fused.py::ddim_fused`
// (`_fused_kernel_factory` -> `_md_layer_t1` for one latent token, the
// general `_md_layer` for T > 1), md_trans=True, and its grid variant
// `ddim_fused_grid`. Per step, for every latent row: the U-skip stack of MD
// layers (self-attention of the latent row over [the T latent rows of its
// sample; cond tokens; time token], post-norm ReLU FFN, linear
// cross-attention, stylized GELU FFN), the skip_linears and the final
// LayerNorm, the classifier-free-guidance mix eps = u + g (c - u) when
// guidance > 1, and the eta=0 DDIM update
//   x0 = (z - sqrt(1 - a_t) eps) / sqrt(a_t),  z' = sqrt(a_prev) x0 + sqrt(1 - a_prev) eps.
// The step-invariant pieces (condition k/v, softmaxed cross-attention key and
// value, and the per-step time-token rows) are computed outside in PyTorch, as
// `ddim_fused_grid` does in XLA. GELU is the exact erf form of the flax
// `Denoiser`; the Pallas kernel used tanh only because Mosaic has no erf.
//
// The design: a cluster of CLUSTER (8) CTAs of 256 threads carries spc
// samples through all steps and layers: their spc T latent rows, or under
// CFG their spc T uncond and spc T cond rows, so the mix needs nothing
// outside the cluster. spc is the fewest samples (at most MAX_SPC, and as
// many as shared memory holds) that let all of the batch's clusters run at
// once (cudaOccupancyMaxActiveClusters: 15 clusters of 8 on an H100, so
// batch 64 runs 13 clusters of 5 samples at T = 1). Each product
// is split by columns over the cluster (`cluster_dense` in ddim_common.cuh):
// a CTA streams its eighth of the weight matrix from L2 once per step, for
// all of the cluster's rows, and pushes its slice of the output (with the
// residual add, where there is one) into every CTA's shared memory; the q, k
// and v products share one exchange, and the skip_linear reads [x; skip]
// from its two buffers. The norms, the attention over the few condition and
// time tokens, the stylization, the mix and the update are repeated in every
// CTA, one warp a row.
//
// The kernel is a template on the latent token count: TF = 1 is the T = 1
// specialisation (every division by T folds away), TF = 0 takes T at run
// time. Each instance is built in a translation unit of its own
// (ddim_md_t1.cu, ddim_md.cu), so that nvcc compiles them side by side.
// Past one token a row's shared memory is the cap: the layout lays the wide
// hidden rows of the sa_block FFN over the q, k and v rows, which are dead
// by then, so a row costs 2 D + max(F1, FF + 2 D, 4 D) + skips floats; at T
// = 10 under CFG one sample is 20 rows, and spc falls to 1 there (64
// clusters at B = 64, in waves).
//
// What bounds it on the H100: not the FMA units (about 11 MFLOP per row per
// step, half a millisecond for a whole call at B = 64) and not device memory
// (the 22 MB of f32 weights read per step stay in the 50 MB L2), but the
// chain of 47 dependent products per step. Each streams a CTA's weight slice
// (2.8 MB a step in all) from L2 in dependent round trips, then pushes and
// waits at a cluster barrier; every cluster re-reads all the weights each
// step. PERF.md has the measured breakdown.

#pragma once

#include <algorithm>

// 256 threads a CTA: this kernel's products need more than the 128
// registers a thread that 512 would leave (`ops/ddim_profile.py --threads`
// compares the two).
#ifndef DDIM_THREADS
#define DDIM_THREADS 256
#endif
#include "ddim_common.cuh"

namespace {

constexpr int D = 256;      // latent width
constexpr int MAX_SPC = 8;  // samples a cluster: R = spc rows, 2 spc under CFG

// Order of the weight pointers of one MD layer in the pointer table; every
// weight is (in, out) row-major. After num_layers such groups come the
// skip_linear weight/bias pairs, the final norm's scale/bias and query_pos row 0.
enum {
  WQ, BQ, WK, BK, WV, BV, WO, BO, LN1G, LN1B, W1, B1, W2, B2, LN2G, LN2B,
  CANG, CANB, WQC, BQC, CASG, CASB, CAOW, CAOB,
  WF1, BF1, WF2, BF2, FSG, FSB, FOW, FOB, PER_LAYER
};

struct Smem {
  float *red, *z, *x, *q, *k, *v, *o, *t, *skip, *lg;
};

// The cluster's rows: n = spc T latent rows a half, row r token r % T of
// sample s0 + (r % n) / T (past the batch end a copy of the last sample,
// never written out); under CFG rows [0, n) are the uncond half, [n, 2 n)
// the cond half. TF != 0 fixes T at compile time.
template <int TF>
struct Rows {
  const float* inv_cond;  // (Bc, NC, 4, D) of the current layer
  int s0, spc, B, NC, T_;
  __device__ __forceinline__ int tokens() const { return TF ? TF : T_; }
  // row r's (NC, 4, D) condition invariants [k, v, ca_key, ca_value]
  __device__ const float* cond(int r) const {
    const int T = tokens(), n = spc * T;
    const int h = r / n, s = min(s0 + (r - h * n) / T, B - 1);
    return inv_cond + (size_t)(h ? B + s : s) * NC * 4 * D;
  }
};

// out = act(A W + b) (+ res) for the R rows, through the cluster.
__device__ void dense(const Operand& A, int K, const float* W, const float* b, int N,
                      float* out, float* red, int act, int R, const float* res = nullptr) {
  const Product p[1] = {{W, b, out, N, N, act, res}};
  cluster_dense(A, K, p, red, R);
}

constexpr int PL = D / 32;  // columns a lane holds of a row

// LayerNorm over D of the row whose PL columns lane + 32 i this lane holds (eps 1e-5).
__device__ __forceinline__ void norm_row(float (&x)[PL], const float* __restrict__ g,
                                         const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PL; ++i) s += x[i];
  const float mean = warp_sum(s) / D;
  float v = 0.f;
#pragma unroll
  for (int i = 0; i < PL; ++i) v += (x[i] - mean) * (x[i] - mean);
  const float inv = rsqrtf(warp_sum(v) / D + 1e-5f);
#pragma unroll
  for (int i = 0; i < PL; ++i) x[i] = (x[i] - mean) * inv * g[lane + 32 * i] + b[lane + 32 * i];
}

// out = LayerNorm_2(LayerNorm_1(in)) and mid = LayerNorm_1(in), one warp a row
// (the sa_block's norm2, then the cross-attention's norm).
__device__ void norm_twice(const float* in, float* mid, float* out, const float* g1,
                           const float* b1, const float* g2, const float* b2, int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NWARP) {
    float x[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i) x[i] = in[r * D + lane + 32 * i];
    norm_row(x, g1, b1);
#pragma unroll
    for (int i = 0; i < PL; ++i) mid[r * D + lane + 32 * i] = x[i];
    norm_row(x, g2, b2);
#pragma unroll
    for (int i = 0; i < PL; ++i) out[r * D + lane + 32 * i] = x[i];
  }
  __syncthreads();
}

// out = silu(LayerNorm(h) * (1 + scale) + shift), the stylization block's
// input with its emb_linear row eo = (scale | shift) precomputed; one warp a row.
__device__ void norm_modulate(const float* h, float* out, const float* g, const float* b,
                              const float* __restrict__ eo, int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NWARP) {
    float x[PL];
#pragma unroll
    for (int i = 0; i < PL; ++i) x[i] = h[r * D + lane + 32 * i];
    norm_row(x, g, b);
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      const int c = lane + 32 * i;
      out[r * D + c] = silu(x[i] * (1.f + eo[c]) + eo[D + c]);
    }
  }
  __syncthreads();
}

// Self-attention of each latent row over [the T latent rows of its sample;
// cond tokens; time token] (one head, scale 1/sqrt(D)) into m.t, one warp a row.
template <int TF>
__device__ void attend(const Smem& m, const Rows<TF>& rows, const float* __restrict__ step,
                       int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int T = rows.tokens(), NC = rows.NC, S = T + NC + 1;
  const float scale = rsqrtf((float)D);
  for (int r = warp; r < R; r += NWARP) {
    const float* cond = rows.cond(r);
    const int g0 = r - r % T;  // the sample's first latent row in this half
    float* lg = m.lg + r * S;
    for (int j = 0; j < S; ++j) {
      const float* key =
          j < T ? m.k + (g0 + j) * D : (j < T + NC ? cond + (j - T) * 4 * D : step);
      const float d = dot_warp<D>(m.q + r * D, key);
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
      const float* val =
          j < T ? m.v + (g0 + j) * D : (j < T + NC ? cond + (4 * (j - T) + 1) * D : step + D);
#pragma unroll
      for (int i = 0; i < PL; ++i) o[i] = fmaf(a, val[lane + 32 * i], o[i]);
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) m.t[r * D + lane + 32 * i] = o[i];
    __syncwarp();
  }
  __syncthreads();
}

// Linear cross-attention of each row into m.t: softmax over D of the query
// row m.q, its dot with every condition token's softmaxed key, and the mix of
// the tokens' values by those weights; one warp a row.
template <int TF>
__device__ void cross_attend(const Smem& m, const Rows<TF>& rows, int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += NWARP) {
    const float* cond = rows.cond(r);
    float x[PL], y[PL] = {};
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      x[i] = m.q[r * D + lane + 32 * i];
      mx = fmaxf(mx, x[i]);
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < PL; ++i) {
      x[i] = expf(x[i] - mx);
      s += x[i];
    }
    const float inv = 1.f / warp_sum(s);
#pragma unroll
    for (int i = 0; i < PL; ++i) x[i] *= inv;
    for (int n = 0; n < rows.NC; ++n) {
      const float* key = cond + (4 * n + 2) * D;
      const float* val = cond + (4 * n + 3) * D;
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) d = fmaf(x[i], key[lane + 32 * i], d);
      d = warp_sum(d);
#pragma unroll
      for (int i = 0; i < PL; ++i) y[i] = fmaf(d, val[lane + 32 * i], y[i]);
    }
#pragma unroll
    for (int i = 0; i < PL; ++i) m.t[r * D + lane + 32 * i] = y[i];
  }
  __syncthreads();
}

// One MD layer for the cluster's R rows (`_md_layer_t1`, `_md_layer`); step
// is this layer's (6, D) time-token row [k, v, ca scale, ca shift, ffn
// scale, ffn shift]. No product writes its own input (see cluster_dense); the
// residual adds ride on the products' pushes.
template <int TF>
__device__ __forceinline__ void md_layer(const float* const* P, const Rows<TF>& rows,
                         const float* __restrict__ step, Smem& m, int F1, int FF, int R) {
  // self-attention of the latent row over [latent; cond; time], out_proj + x, norm1
  const Product qkv[3] = {{P[WQ], P[BQ], m.q, D, D, ACT_NONE},
                          {P[WK], P[BK], m.k, D, D, ACT_NONE},
                          {P[WV], P[BV], m.v, D, D, ACT_NONE}};
  cluster_dense(rows_of(m.x, D), D, qkv, m.red, R);
  attend(m, rows, step, R);
  dense(rows_of(m.t, D), D, P[WO], P[BO], D, m.o, m.red, ACT_NONE, R, m.x);
  layernorm<D>(m.o, m.x, P[LN1G], P[LN1B], R);
  // post-norm ReLU FFN of the self-attention block, + x, norm2, then the
  // cross-attention's norm
  dense(rows_of(m.x, D), D, P[W1], P[B1], F1, m.t, m.red, ACT_RELU, R);
  dense(rows_of(m.t, F1), F1, P[W2], P[B2], D, m.o, m.red, ACT_NONE, R, m.x);
  norm_twice(m.o, m.x, m.o, P[LN2G], P[LN2B], P[CANG], P[CANB], R);
  // linear cross-attention, stylized into x
  dense(rows_of(m.o, D), D, P[WQC], P[BQC], D, m.q, m.red, ACT_NONE, R);
  cross_attend(m, rows, R);
  norm_modulate(m.t, m.o, P[CASG], P[CASB], step + 2 * D, R);
  dense(rows_of(m.o, D), D, P[CAOW], P[CAOB], D, m.x, m.red, ACT_NONE, R, m.x);
  // stylized GELU FFN into x
  dense(rows_of(m.x, D), D, P[WF1], P[BF1], FF, m.t, m.red, ACT_GELU, R);
  dense(rows_of(m.t, FF), FF, P[WF2], P[BF2], D, m.k, m.red, ACT_NONE, R);
  norm_modulate(m.k, m.o, P[FSG], P[FSB], step + 4 * D, R);
  dense(rows_of(m.o, D), D, P[FOW], P[FOB], D, m.x, m.red, ACT_NONE, R, m.x);
}

// Floats of red for R rows: the widest partials of the kernel's products.
__host__ __device__ int red_size(int R, int F1, int FF) {
  const int a = red_floats(D, R), b = red_floats(F1, R), c = red_floats(FF, R);
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// The offset of k from t, in floats a row (q sits at D, past the attention
// output's rows; k past the stylized FFN's hidden rows), and the floats a
// row of the t region.
__host__ __device__ int k_at(int FF) { return FF > 2 * D ? FF : 2 * D; }
__host__ __device__ int t_width(int F1, int FF) {
  return F1 > k_at(FF) + 2 * D ? F1 : k_at(FF) + 2 * D;
}

// Shared-memory floats for R rows of spc samples of T tokens.
size_t smem_floats(int R, int spc, int T, int NC, int F1, int FF, int L) {
  const int nb = (L - 1) / 2;
  const int lg = (R * (T + NC + 1) + 3) / 4 * 4;
  return (size_t)red_size(R, F1, FF) + spc * T * D + 2 * R * D + R * t_width(F1, FF) +
         nb * R * D + lg;
}

template <int TF>
__global__ void __launch_bounds__(NT, 1)
ddim_md_kernel(const float* __restrict__ z0, float* __restrict__ z_out,
               const float* __restrict__ inv_cond, const float* __restrict__ inv_step,
               const float* const* __restrict__ P, const float* __restrict__ acp_t,
               const float* __restrict__ acp_prev, const float* __restrict__ pe, int B, int Bc,
               int NC, int F1, int FF, int L, int steps, float guidance, int cfg, int spc,
               int T_) {
  const int T = TF ? TF : T_;
  const int nb = (L - 1) / 2, n = spc * T, R = cfg ? 2 * n : n;  // n: latent rows a half
  const int s0 = blockIdx.x / CLUSTER * spc;  // the cluster's first sample
  extern __shared__ __align__(16) float smem[];
  Smem m;
  m.red = smem;
  m.z = m.red + red_size(R, F1, FF);
  m.x = m.z + n * D;
  m.o = m.x + R * D;  // q, k, v under the t region's wide rows (see the top)
  m.t = m.o + R * D;
  m.q = m.t + R * D;
  m.k = m.t + R * k_at(FF);
  m.v = m.k + R * D;
  m.skip = m.t + R * t_width(F1, FF);
  m.lg = m.skip + nb * R * D;

  for (int i = threadIdx.x; i < n * D; i += NT)
    m.z[i] = z0[(size_t)min(s0 + i / (T * D), B - 1) * T * D + i % (T * D)];
  __syncthreads();

  const float* const* G = P + L * PER_LAYER;  // skip linears, final norm, pe row
  const float* pe_rows = TF == 1 ? G[2 * nb + 2] : pe;  // (T, D) positional rows
  Rows<TF> rows{inv_cond, s0, spc, B, NC, T};
  for (int it = 0; it < steps; ++it) {
    for (int i = threadIdx.x; i < R * D; i += NT) {
      const int l = i / D % n, c = i % D;  // the half's latent row l is token l % T
      m.x[i] = m.z[l * D + c] + pe_rows[(l % T) * D + c];
    }
    __syncthreads();
    for (int l = 0; l < L; ++l) {
      if (l > nb) {  // output block j: skip_linear over [x; skip of input block nb-1-j]
        const int j = l - nb - 1;
        const Operand xs{m.x, m.skip + (nb - 1 - j) * R * D, D, D, D};
        dense(xs, 2 * D, G[2 * j], G[2 * j + 1], D, m.o, m.red, ACT_NONE, R);
        float* x = m.o;  // the same swap in every CTA: the buffers keep their offsets
        m.o = m.x;
        m.x = x;
      }
      rows.inv_cond = inv_cond + (size_t)l * Bc * NC * 4 * D;
      md_layer(P + l * PER_LAYER, rows, inv_step + ((size_t)l * steps + it) * 6 * D, m, F1, FF,
               R);
      if (l < nb) {
        for (int i = threadIdx.x; i < R * D; i += NT) m.skip[l * R * D + i] = m.x[i];
        __syncthreads();
      }
    }
    layernorm<D>(m.x, m.o, G[2 * nb], G[2 * nb + 1], R);  // eps rows
    const float at = acp_t[it], ap = acp_prev[it];
    const float c_eps = sqrtf(1.f - at), inv_sa = 1.f / sqrtf(at);
    const float sa_prev = sqrtf(ap), c_prev = sqrtf(1.f - ap);
    for (int i = threadIdx.x; i < n * D; i += NT) {
      float e = m.o[i];
      if (cfg) e = e + guidance * (m.o[n * D + i] - e);
      const float x0 = (m.z[i] - c_eps * e) * inv_sa;
      m.z[i] = sa_prev * x0 + c_prev * e;
    }
    __syncthreads();
  }
  if (blockIdx.x % CLUSTER == 0)  // every CTA of the cluster holds the same z
    for (int i = threadIdx.x; i < n * D; i += NT) {
      const int s = s0 + i / (T * D);
      if (s < B) z_out[(size_t)s0 * T * D + i] = m.z[i];
    }
}

// The widths the kernel takes: every product's output splits over the cluster.
bool takes(int NC, int D_, int F1, int FF, int L, int B, int T) {
  return D_ == D && splits(D) && splits(F1) && splits(FF) && L % 2 == 1 && NC >= 1 && B >= 1 &&
         T >= 1;
}

// The launch of instance TF for B samples of T tokens: samples a cluster so
// that all clusters fit on the card at once where MAX_SPC and the card's
// shared memory a CTA allow.
template <int TF>
struct Plan {
  int spc, R;
  size_t smem;
  int err;
  Plan(int B, int T, int NC, int F1, int FF, int L, int cfg) {
    const int H = cfg ? 2 : 1;
    int most = MAX_SPC, dev = 0, cap = 0;  // as many samples as one CTA's shared memory holds
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    while (most > 0 &&
           smem_floats(H * most * T, most, T, NC, F1, FF, L) * sizeof(float) > (size_t)cap)
      --most;
    spc = R = 0;
    smem = 0;
    if (most == 0) {
      err = REFUSE_SAMPLE_SMEM;
      return;
    }
    int fit = 0;
    err = ClusterLaunch(1, smem_floats(H * most * T, most, T, NC, F1, FF, L) * sizeof(float),
                        nullptr).active(&ddim_md_kernel<TF>, &fit);
    spc = samples_per_cluster(B, fit, most);
    R = H * spc * T;
    smem = smem_floats(R, spc, T, NC, F1, FF, L) * sizeof(float);
  }
  int clusters(int B) const { return (B + spc - 1) / spc; }
};

template <int TF>
int launch(const float* z0, float* z_out, const float* inv_cond, const float* inv_step,
           const void* wptr, const float* acp_t, const float* acp_prev, const float* pe, int B,
           int Bc, int NC, int F1, int FF, int L, int steps, int T, float guidance, int cfg,
           void* stream) {
  const Plan<TF> plan(B, T, NC, F1, FF, L, cfg);
  if (plan.err != cudaSuccess) return plan.err;
  const ClusterLaunch launch(plan.clusters(B), plan.smem, stream);
  cudaError_t err = launch.setup(&ddim_md_kernel<TF>);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&launch.config, &ddim_md_kernel<TF>, z0, z_out, inv_cond, inv_step,
                           static_cast<const float* const*>(wptr), acp_t, acp_prev, pe, B, Bc,
                           NC, F1, FF, L, steps, guidance, cfg, plan.spc, T);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch `launch<TF>` makes, without launching: info[5] = CTAs per
// cluster, CTAs in the grid, clusters that fit at once, dynamic shared
// memory bytes per CTA, samples a cluster.
template <int TF>
int describe(int B, int T, int NC, int F1, int FF, int L, int cfg, int* info) {
  const Plan<TF> plan(B, T, NC, F1, FF, L, cfg);
  if (plan.err != cudaSuccess) return plan.err;
  info[4] = plan.spc;
  return ClusterLaunch(plan.clusters(B), plan.smem, nullptr).describe(&ddim_md_kernel<TF>, info);
}

}  // namespace
