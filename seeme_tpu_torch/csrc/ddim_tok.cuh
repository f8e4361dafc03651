// The whole DDIM reverse process over the plain token-concat denoiser in one
// launch, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `seeme_tpu/ops/denoiser_fused.py::ddim_fused` with
// md_trans=False (`_fused_kernel_factory` -> `denoiser_apply_pure`'s
// token-concat branch, `_encoder_layer` / `_mha_1head`), the text-to-motion
// sampler. Per step and per sample, the token sequence [x_0..T-1; time;
// cond_0..NC-1] (positional rows 0..S-1 added, S = T + 1 + NC) runs the U-skip stack of
// post-norm encoder layers: q/k/v of every token row, attention in NH heads
// over the S tokens of the same sample (head h over columns [h D/NH, (h+1)
// D/NH), scale 1/sqrt(D/NH), as `nn/transformer.py::MultiHeadAttention`),
// out_proj, residual, LayerNorm, Linear -> exact-erf GELU -> Linear,
// residual, LayerNorm; each output layer after its skip_linear over [h;
// skip]. Then the final LayerNorm of tokens 0..T-1, the
// classifier-free-guidance mix eps = u + g (c - u) when guidance > 1, and
// the eta=0 DDIM update
//   x0 = (z - sqrt(1 - a_t) eps) / sqrt(a_t),  z' = sqrt(a_prev) x0 + sqrt(1 - a_prev) eps.
// The time and condition rows attend to x, so every row of every sample runs
// every layer every step. The condition projection relu -> emb_proj and every
// step's time token (the sinusoid at the text width, then the MLP) are
// computed outside in PyTorch, once per window, with their positional rows.
// The TPU kernel's attention is one head at any num_heads; this one takes the
// model's head count, so a multi-head model samples the function it trained.
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
// Two layouts of shared memory, chosen by the feed-forward width FF:
//  * FF <= D (the narrow layout): the FFN's hidden rows (R x FF) share the
//    v buffer, both FFN products split by columns, and every CTA keeps the
//    (L - 1) / 2 skip rows whole.
//  * D < FF <= 1024, the widest that splits (the wide layout; MLD's
//    published 9 layers and FF 1024): the hidden rows (R x FF) and the
//    skips ((L - 1) / 2 x R x D) would be past a CTA's 227 KB at 30 rows.
//    So the FFN is split by depth: each CTA computes only its own FF / 8
//    hidden columns (its column slice of linear1, no exchange) and from them
//    a partial of all D output columns (its row slice of linear2); each
//    partial's column slice d goes to CTA d, which sums the 8 in rank order,
//    adds the bias and the residual and pushes the rows to every CTA, as a
//    column-split product does (`ffn_split`). And each CTA keeps only its
//    own D / 8 columns of every skip; an output layer first gathers the
//    whole skip rows from the cluster's shared memory (`gather_skip`).
//    201 120 bytes a CTA at 5 samples, 9 layers and FF 1024. Its products
//    (`wide_dense`, `local_pass`) give the 4 lanes of a quad different
//    k-slices where the rows allow, so that a warp has 4 KB of weights in
//    flight where the narrow layout's have 1.
// Each value of a row is computed by one CTA in one order and copied to the
// others, so every CTA holds the same rows.
//
// The kernel is a template on the latent token count: TF = 1 is the T = 1
// specialisation (T a compile-time constant: every division by T folds
// away), TF = 0 takes T at run time; on the layout (WIDE), so that the
// narrow instances carry none of the wide layout's code; and on the
// attention (HEADS), so that an instance carries one of the two: with both
// in the wide instance MLD's shape ran 15% slower on the H100 (PERF.md).
// The instances of each TF are built in a translation unit of their own
// (ddim_tok_t1.cu, ddim_tok.cu), so that nvcc compiles them side by side.
// At T = 10, one condition token and CFG a sample is 24 rows, so a cluster
// carries one sample and batch 64 runs in waves of the clusters that fit.
//
// What bounds it on the H100: at batch 64 and guidance 7.5 a step is 384
// token rows through the layers' dependent small products: at 5 layers and
// FF 128 about 0.66 MFLOP per row per layer (73 GFLOP per call with the
// skips, f32 weights about 7.6 MB a step), at MLD's 9 layers, FF 1024 and 4
// heads about 1.58 MFLOP (292 GFLOP a call, about 30 MB a step), which the
// FMA units of 104 SMs would finish in about 1.1 and 5.6 ms. The weights stay
// in the 50 MB L2. The products take about three quarters of a step at
// MLD's widths (clock counts per phase, PERF.md), at about a third of the
// FMA rate: each lane's weights come from L2 a few float4s at a time, and
// each float4 of A and of W feeds only 16 FMAs, so the loads through L1 and
// shared memory keep pace with the FMAs at best. Attention, the norms, the
// pushes and the cluster barriers of a step (22 groups at 5 layers, 31 at
// MLD's widths) take the rest.

#pragma once

#include <algorithm>

#include "ddim_common.cuh"

namespace {

constexpr int D = 256;        // latent width
constexpr int MAX_NC = 8;     // condition tokens
constexpr int MAX_ROWS = DDIM_TOK_MAX_ROWS;  // token rows a cluster
constexpr int MAX_SPC = 8;    // samples a cluster
constexpr int SLICE = D / CLUSTER;  // columns of a D-wide product a CTA owns

// Order of the weight pointers of one encoder layer in the pointer table; every
// weight is (in, out) row-major. After num_layers such groups come the
// skip_linear weight/bias pairs, the final norm's scale/bias and query_pos row 0.
enum { WQ, BQ, WK, BK, WV, BV, WO, BO, LN1G, LN1B, W1, B1, W2, B2, LN2G, LN2B, PER_LAYER };

struct Smem {
  float *red, *z, *e, *x, *q, *k, *v, *hid, *skip, *lg;
};

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

// Attention as `attend`, in NH heads (head h over columns [h hw, (h + 1)
// hw), hw = D / NH a multiple of 32, scale 1/sqrt(hw)), as
// `nn/transformer.py::MultiHeadAttention`. A row's NH x S logits in m.lg
// become its softmax weights (lane h: head h); a head's S keys are summed
// four at a time.
__device__ void attend_heads(const Smem& m, const float* v, int R, int S, int NH) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int hw = D / NH;
  const float scale = rsqrtf((float)hw);
  for (int r = warp; r < R; r += NWARP) {
    const int g0 = r - r % S;  // the group's first row
    float* lg = m.lg + r * NH * S;
    const float* qr = m.q + r * D;
    for (int h = 0; h < NH; ++h)
      for (int j0 = 0; j0 < S; j0 += 4) {  // four keys' warp sums side by side
        float d[4] = {};
        for (int c = h * hw + lane; c < (h + 1) * hw; c += 32) {
          const float qc = qr[c];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (j0 + u < S) d[u] = fmaf(qc, m.k[(g0 + j0 + u) * D + c], d[u]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < 4; ++u) d[u] += __shfl_xor_sync(0xffffffffu, d[u], o);
        if (lane == 0)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (j0 + u < S) lg[h * S + j0 + u] = d[u] * scale;
      }
    __syncwarp();
    if (lane < NH) {
      float* w = lg + lane * S;
      float mx = w[0];
      for (int j = 1; j < S; ++j) mx = fmaxf(mx, w[j]);
      float sum = 0.f;
      for (int j = 0; j < S; ++j) sum += expf(w[j] - mx);
      for (int j = 0; j < S; ++j) w[j] = expf(w[j] - mx) / sum;
    }
    __syncwarp();
    float o[PL] = {};
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int i = 0; i < PL; ++i)
        o[i] = fmaf(lg[32 * i / hw * S + j], v[(g0 + j) * D + lane + 32 * i], o[i]);
#pragma unroll
    for (int i = 0; i < PL; ++i) m.q[r * D + lane + 32 * i] = o[i];
    __syncwarp();
  }
  __syncthreads();
}

// How a CTA's own product of nc columns (nc / 32 column groups of 8 float4
// quads) over nr rows spreads over its warps: each group takes WG = NWARP /
// (nc / 32) warps in RG row groups times K-groups, and the 4 lanes of a
// quad split into RS row slots times 4 / RS k-slices. Unlike Split, RG,
// then RS, is the fewest that leaves a lane at most RPL_MAX rows: the lanes
// of a quad read different weights where they can, so a warp has up to 4 KB
// of weights in flight and not 1, where the products wait on L2 (on the
// H100 at MLD's widths 31.4 ms a call against 37.2 with row slots first; 8
// rows a lane spilled registers and took 33.0).
struct LocalSplit {
  int WG, RS, RG;
  __host__ __device__ constexpr LocalSplit(int nc, int nr)
      : WG(NWARP / (nc / 32)), RS(1), RG(1) {
    while (RG < WG && RG * RPL_MAX < nr) RG <<= 1;
    while (RS < 4 && RS * RG * RPL_MAX < nr) RS <<= 1;
  }
  __host__ __device__ constexpr int slots() const { return RS * RG; }
  __host__ __device__ constexpr int kgroups() const { return WG / RG; }
  __host__ __device__ constexpr int kslices() const { return 4 / RS; }
};

// The nc columns of A W that start at W (row stride ldw) for the nr rows of
// A (K wide), this CTA's alone: lane (ks, rs, q) of a warp of column group cg
// takes columns cg * 32 + 4q .. + 3, as slice_pass takes a quad. The
// K-groups' partial sums go to red[(kg * nr + r) * nc + c]; on return, after
// a __syncthreads, all of them are there.
template <int RPL>
__device__ void local_pass(const Operand& A, int K, const float* W, int ldw, int nc, float* red,
                           int nr) {
  const LocalSplit sp(nc, nr);
  const int KG = sp.kgroups(), KS = sp.kslices(), kw = K / KG, slots = sp.slots();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, q = lane & 7, g = lane >> 3;
  const int w = warp % sp.WG, kg = w % KG, ks = g / sp.RS;
  const int r0 = w / KG * sp.RS + g % sp.RS;
  const int c = warp / sp.WG * 32 + 4 * q;
  const int k0 = kg * kw, n4 = ldw >> 2;
  const float4* W4 = reinterpret_cast<const float4*>(W + (size_t)k0 * ldw + c);
  float4 acc[RPL];
#pragma unroll
  for (int i = 0; i < RPL; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int kk = 4 * ks; kk < kw; kk += 8 * KS) {
    const int k1 = kk + 4 * KS;
    const bool two = k1 < kw;
    float4 w0[4], w1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) w0[j] = __ldg(W4 + (size_t)(kk + j) * n4);
    if (two)
#pragma unroll
      for (int j = 0; j < 4; ++j) w1[j] = __ldg(W4 + (size_t)(k1 + j) * n4);
    fma_rows<RPL>(A, k0 + kk, r0, slots, nr, w0, acc);
    if (two) fma_rows<RPL>(A, k0 + k1, r0, slots, nr, w1, acc);
  }
  for (int o = 8 * sp.RS; o < 32; o <<= 1)  // the k-slices of a quad
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      acc[i].x += __shfl_xor_sync(0xffffffffu, acc[i].x, o);
      acc[i].y += __shfl_xor_sync(0xffffffffu, acc[i].y, o);
      acc[i].z += __shfl_xor_sync(0xffffffffu, acc[i].z, o);
      acc[i].w += __shfl_xor_sync(0xffffffffu, acc[i].w, o);
    }
  __syncthreads();  // the previous product is done reading red
  if (ks == 0)
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const int r = r0 + i * slots;
      if (r < nr) *reinterpret_cast<float4*>(red + (kg * nr + r) * nc + c) = acc[i];
    }
  __syncthreads();
}

// local_pass with as many rows a lane as nr needs; returns the K-groups.
__device__ int local_product(const Operand& A, int K, const float* W, int ldw, int nc,
                             float* red, int nr) {
  const LocalSplit sp(nc, nr);
  const int rpl = (nr + sp.slots() - 1) / sp.slots();
  if (rpl <= 1)
    local_pass<1>(A, K, W, ldw, nc, red, nr);
  else if (rpl == 2)
    local_pass<2>(A, K, W, ldw, nc, red, nr);
  else
    local_pass<RPL_MAX>(A, K, W, ldw, nc, red, nr);
  return sp.kgroups();
}

// The sum of the KG partials of red at row r, column c (of nc).
__device__ __forceinline__ float4 red_sum(const float* red, int KG, int nr, int nc, int r,
                                          int c, float4 v) {
  for (int k = 0; k < KG; ++k) {
    const float4 u = *reinterpret_cast<const float4*>(red + (k * nr + r) * nc + c);
    v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
  }
  return v;
}

// The wide layout's products that split by columns over the cluster (N =
// D): as cluster_dense, each CTA its SLICE columns, through local_pass.
template <int M>
__device__ void wide_dense(const Operand& A, int K, const Product (&ps)[M], float* red, int R) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c0 = (int)cluster.block_rank() * SLICE, q = 4 * (threadIdx.x % (SLICE / 4));
  cluster_arrive_relaxed();  // this CTA is done with the outputs: the others may push into them
#pragma unroll
  for (int n = 0; n < M; ++n) {
    const Product& p = ps[n];
    const float4 b = __ldg(reinterpret_cast<const float4*>(p.bias + c0 + q));
    const int KG = local_product(A, K, p.W + c0, D, SLICE, red, R);
    if (n == 0) cluster_wait();
    for (int it = threadIdx.x; it < R * SLICE / 4; it += NT) {
      const int r = it / (SLICE / 4), c = 4 * (it % (SLICE / 4));
      const float4* bias4 = reinterpret_cast<const float4*>(p.bias + c0 + c);
      float4 v = red_sum(red, KG, R, SLICE, r, c, it == threadIdx.x ? b : __ldg(bias4));
      v = make_float4(activate(v.x, p.act), activate(v.y, p.act), activate(v.z, p.act),
                      activate(v.w, p.act));
      const int at = r * p.ldo + c0 + c;
      if (p.res) {
        const float4 u = *reinterpret_cast<const float4*>(p.res + at);
        v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
      }
#pragma unroll
      for (int d = 0; d < CLUSTER; ++d)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(p.out + at, d)) = v;
    }
  }
  cluster_arrive();  // every push of this CTA is done
  cluster_wait();
}

// out = act(A W + b) (+ res) for the R rows, through the cluster, in the
// layout's products.
template <bool WIDE>
__device__ void dense_in(const Operand& A, int K, const float* W, const float* b, int N,
                         float* out, float* red, int act, int R, const float* res = nullptr) {
  const Product p[1] = {{W, b, out, N, N, act, res}};
  if (WIDE)
    wide_dense(A, K, p, red, R);
  else
    cluster_dense(A, K, p, red, R);
}

// The wide layout's feed-forward, split by depth: m.k = m.x + GELU(m.x W1 +
// b1) W2 + b2 for the R rows, on every CTA of the cluster. This CTA's FF / 8
// hidden columns go to m.hid; its partial over them of all D output columns
// goes column slice d to CTA d's m.v, in slot rank (v is free since the
// out_proj group's barrier); after the barrier each CTA sums its slice's 8
// partials in rank order, adds b2 and the residual and pushes its columns
// into every CTA's m.k (free since that CTA's LayerNorm read it).
__device__ void ffn_split(const float* const* P, const Smem& m, int R, int FF) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), nc = FF / CLUSTER;
  int KG = local_product(rows_of(m.x, D), D, P[W1] + rank * nc, FF, nc, m.red, R);
  for (int it = threadIdx.x; it < R * nc / 4; it += NT) {
    const int r = it / (nc / 4), c = 4 * (it % (nc / 4));
    float4 v = red_sum(m.red, KG, R, nc, r, c,
                       __ldg(reinterpret_cast<const float4*>(P[B1] + rank * nc + c)));
    v = make_float4(activate(v.x, ACT_GELU), activate(v.y, ACT_GELU), activate(v.z, ACT_GELU),
                    activate(v.w, ACT_GELU));
    *reinterpret_cast<float4*>(m.hid + r * nc + c) = v;
  }
  __syncthreads();
  KG = local_product(rows_of(m.hid, nc), nc, P[W2] + (size_t)rank * nc * D, D, D, m.red, R);
  for (int it = threadIdx.x; it < R * D / 4; it += NT) {
    const int r = it / (D / 4), c = 4 * (it % (D / 4));
    const float4 v = red_sum(m.red, KG, R, D, r, c, make_float4(0.f, 0.f, 0.f, 0.f));
    float* dst = m.v + (rank * R + r) * SLICE + c % SLICE;
    *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, c / SLICE)) = v;
  }
  cluster_arrive();
  cluster_wait();
  for (int it = threadIdx.x; it < R * SLICE / 4; it += NT) {
    const int r = it / (SLICE / 4), c = 4 * (it % (SLICE / 4)), col = rank * SLICE + c;
    float4 v = __ldg(reinterpret_cast<const float4*>(P[B2] + col));
    for (int d = 0; d < CLUSTER; ++d) {
      const float4 u = *reinterpret_cast<const float4*>(m.v + (d * R + r) * SLICE + c);
      v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
    }
    const float4 u = *reinterpret_cast<const float4*>(m.x + r * D + col);
    v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
    float* dst = m.k + r * D + col;
#pragma unroll
    for (int d = 0; d < CLUSTER; ++d)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, d)) = v;
  }
  cluster_arrive();
  cluster_wait();
}

// One post-norm GELU encoder layer over the cluster's R token rows, which are
// R / S groups (a sample's uncond or cond half) of S tokens; attention stays
// within a group. In the narrow layout m.hid is m.v: v during attention,
// then the FFN's hidden rows. No product writes its own input (see
// cluster_dense); the residual adds ride on the products' pushes.
template <bool WIDE, bool HEADS>
__device__ void encoder_layer(const float* const* P, Smem& m, int R, int S, int FF, int NH) {
  const Product qkv[3] = {{P[WQ], P[BQ], m.q, D, D, ACT_NONE},
                          {P[WK], P[BK], m.k, D, D, ACT_NONE},
                          {P[WV], P[BV], m.v, D, D, ACT_NONE}};
  if (WIDE)
    wide_dense(rows_of(m.x, D), D, qkv, m.red, R);
  else
    cluster_dense(rows_of(m.x, D), D, qkv, m.red, R);
  if (HEADS)
    attend_heads(m, m.v, R, S, NH);
  else
    attend(m, m.v, R, S);
  dense_in<WIDE>(rows_of(m.q, D), D, P[WO], P[BO], D, m.k, m.red, ACT_NONE, R, m.x);
  layernorm<D>(m.k, m.x, P[LN1G], P[LN1B], R);
  if (WIDE) {
    ffn_split(P, m, R, FF);
  } else {
    dense_in<false>(rows_of(m.x, D), D, P[W1], P[B1], FF, m.hid, m.red, ACT_GELU, R);
    dense_in<false>(rows_of(m.hid, FF), FF, P[W2], P[B2], D, m.k, m.red, ACT_NONE, R, m.x);
  }
  layernorm<D>(m.k, m.x, P[LN2G], P[LN2B], R);
}

// The wide layout: the whole rows of skip b into out, column slice d from
// CTA d (each CTA keeps its own slice, written long before, after cluster
// barriers; out is this CTA's own until its next q/k/v exchange).
__device__ void gather_skip(const Smem& m, int b, int R, float* out) {
  cg::cluster_group cluster = cg::this_cluster();
  const float* src = m.skip + b * R * SLICE;
  for (int it = threadIdx.x; it < R * D / 4; it += NT) {
    const int r = it / (D / 4), c = 4 * (it % (D / 4));
    const float* at = cluster.map_shared_rank(src + r * SLICE + c % SLICE, c / SLICE);
    *reinterpret_cast<float4*>(out + r * D + c) = *reinterpret_cast<const float4*>(at);
  }
  __syncthreads();
}

// Floats of red for R rows: the widest partials of the kernel's products.
__host__ __device__ int red_size(int R, int FF) {
  if (FF <= D) {
    const int a = red_floats(D, R), b = red_floats(FF, R);
    return a > b ? a : b;
  }
  const int b = LocalSplit(FF / CLUSTER, R).kgroups() * R * (FF / CLUSTER);  // linear1's
  const int c = LocalSplit(D, R).kgroups() * R * D;                          // linear2's
  const int a = LocalSplit(SLICE, R).kgroups() * R * SLICE;                  // the others'
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// Shared-memory floats for the cluster's spc samples of T latent tokens, H
// halves of S rows each, in the layout FF chooses.
size_t smem_floats(int spc, int T, int H, int S, int FF, int L, int NH) {
  const int nb = (L - 1) / 2, R = spc * H * S;
  const int lg = (R * NH * S + 3) / 4 * 4;
  const size_t rows = spc * T * D + spc * H * T * D + 4 * R * D + lg;
  if (FF > D) return red_size(R, FF) + rows + R * FF / CLUSTER + nb * R * SLICE;
  return red_size(R, FF) + rows + nb * R * D;
}

// WIDE: the wide layout (FF > D), else the narrow one; HEADS: attention in
// NH heads (attend_heads), else in one (attend, NH = 1).
template <int TF, bool WIDE, bool HEADS>
__global__ void __launch_bounds__(NT, 1)
ddim_tok_kernel(const float* __restrict__ z0, float* __restrict__ z_out,
                const float* __restrict__ cond_in, const float* __restrict__ time_in,
                const float* const* __restrict__ P, const float* __restrict__ acp_t,
                const float* __restrict__ acp_prev, const float* __restrict__ pe, int B, int NC,
                int FF, int L, int NH, int steps, float guidance, int cfg, int spc, int T_) {
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
  m.v = m.k + R * D;  // v (R x D); narrow: then the FFN's hidden rows (R x FF <= R x D)
  m.hid = WIDE ? m.v + R * D : m.v;  // wide: this CTA's FF / 8 hidden columns
  m.skip = m.v + R * D + (WIDE ? R * FF / CLUSTER : 0);  // wide: this CTA's column slices
  m.lg = m.skip + nb * R * (WIDE ? SLICE : D);

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
        const float* skip = m.skip + (nb - 1 - j) * R * D;
        if (WIDE) {
          gather_skip(m, nb - 1 - j, R, m.k);
          skip = m.k;
        }
        const Operand xs{m.x, skip, D, D, D};
        dense_in<WIDE>(xs, 2 * D, G[2 * j], G[2 * j + 1], D, m.q, m.red, ACT_NONE, R);
        float* x = m.q;  // the same swap in every CTA: the buffers keep their offsets
        m.q = m.x;
        m.x = x;
      }
      encoder_layer<WIDE, HEADS>(P + l * PER_LAYER, m, R, S, FF, NH);
      if (l < nb) {
        if (WIDE) {
          const int c0 = (int)cg::this_cluster().block_rank() * SLICE;
          for (int i = threadIdx.x; i < R * SLICE; i += NT)
            m.skip[l * R * SLICE + i] = m.x[i / SLICE * D + c0 + i % SLICE];
        } else {
          for (int i = threadIdx.x; i < R * D; i += NT) m.skip[l * R * D + i] = m.x[i];
        }
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

// The shapes the kernel takes: both product widths split over the cluster
// (so FF <= 1024). Heads that are not whole warp passes are refused
// (refusals.cuh).
bool takes(int NC, int FF, int L, int B, int T) {
  return splits(D) && splits(FF) && L % 2 == 1 && NC >= 1 && NC <= MAX_NC && B >= 1 && T >= 1;
}
int refusal(int NH) { return NH < 1 || D % NH || D / NH % 32 ? REFUSE_TOK_HEADS : 0; }

// The instance of latent tokens TF for feed-forward width FF and NH heads
// (the wide layout in attend_heads at any NH).
template <int TF>
auto kernel_for(int FF, int NH) {
  if (FF > D) return &ddim_tok_kernel<TF, true, true>;
  return NH > 1 ? &ddim_tok_kernel<TF, false, true> : &ddim_tok_kernel<TF, false, false>;
}

// The launch of instance TF for B samples of T latent and NC condition
// tokens (cfg: two halves each): samples a cluster so that all clusters fit
// on the card at once, within MAX_ROWS token rows, MAX_SPC samples and the
// card's shared memory a CTA.
template <int TF>
struct Plan {
  int spc;
  size_t smem;
  int err;
  Plan(int B, int T, int NC, int FF, int L, int NH, int cfg) {
    const int H = cfg ? 2 : 1, S = T + 1 + NC;
    spc = 0;
    smem = 0;
    if (H * S > MAX_ROWS) {
      err = REFUSE_TOKEN_ROWS;
      return;
    }
    int most = std::min(MAX_SPC, MAX_ROWS / (H * S));
    int dev = 0, cap = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    while (most > 0 && smem_floats(most, T, H, S, FF, L, NH) * sizeof(float) > (size_t)cap)
      --most;
    if (most == 0) {
      err = REFUSE_SAMPLE_SMEM;
      return;
    }
    int fit = 0;
    err = ClusterLaunch(1, smem_floats(most, T, H, S, FF, L, NH) * sizeof(float), nullptr)
              .active(kernel_for<TF>(FF, NH), &fit);
    spc = samples_per_cluster(B, fit, most);
    smem = smem_floats(spc, T, H, S, FF, L, NH) * sizeof(float);
  }
  int clusters(int B) const { return (B + spc - 1) / spc; }
};

template <int TF>
int launch(const float* z0, float* z_out, const float* cond_in, const float* time_in,
           const void* wptr, const float* acp_t, const float* acp_prev, const float* pe, int B,
           int NC, int FF, int L, int NH, int steps, int T, float guidance, int cfg,
           void* stream) {
  const Plan<TF> plan(B, T, NC, FF, L, NH, cfg);
  if (plan.err != cudaSuccess) return plan.err;
  const ClusterLaunch launch(plan.clusters(B), plan.smem, stream);
  const auto kernel = kernel_for<TF>(FF, NH);
  cudaError_t err = launch.setup(kernel);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&launch.config, kernel, z0, z_out, cond_in, time_in,
                           static_cast<const float* const*>(wptr), acp_t, acp_prev, pe, B, NC, FF,
                           L, NH, steps, guidance, cfg, plan.spc, T);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The launch `launch<TF>` makes, without launching: info[5] = CTAs per
// cluster, CTAs in the grid, clusters that fit at once, dynamic shared
// memory bytes per CTA, samples a cluster.
template <int TF>
int describe(int B, int T, int NC, int FF, int L, int NH, int cfg, int* info) {
  const Plan<TF> plan(B, T, NC, FF, L, NH, cfg);
  if (plan.err != cudaSuccess) return plan.err;
  info[4] = plan.spc;
  return ClusterLaunch(plan.clusters(B), plan.smem, nullptr)
      .describe(kernel_for<TF>(FF, NH), info);
}

}  // namespace
