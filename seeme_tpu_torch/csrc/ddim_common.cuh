// Device helpers shared by the two DDIM kernels, `ddim_md.cu` and `ddim_tok.cu`:
// the dense products of one thread-block cluster, row LayerNorm and warp
// reductions. Every CTA has NT threads.
//
// The cluster design. A cluster of CLUSTER CTAs carries a group of rows
// through every step. Each CTA owns one column slice of every weight matrix
// (N / CLUSTER columns), streams only that slice from L2, once per step, for
// all of the cluster's rows, and pushes its slice of the product into the
// output rows of every CTA of the cluster through distributed shared memory.
// After the cluster barrier every CTA holds the full output rows, so all the
// row-wise work (norms, attention over a sample's few tokens, the CFG mix, the
// DDIM update) is repeated in every CTA and needs no further exchange. The
// weight bytes a cluster reads per step are those one CTA read before, spread
// over CLUSTER SMs.
//
// The barrier protocol of one product group (`cluster_dense`): each CTA
// arrives (relaxed) on the cluster barrier when it is done with the group's
// output buffers (everything before the call), computes its slices, waits
// for that phase before its first push, pushes, then arrives (release) and
// waits (acquire) again; after that every push of the group has landed. So
// the first barrier phase waits behind the slice's weight stream, and only
// the second is on the critical path. An output buffer must not be an input
// of its own group.
//
// What bounds both kernels on the H100 (PERF.md): each product's weight
// slice comes from L2 in one to four dependent round trips a lane, and at
// batch 64 the clusters together re-read every weight once per step each;
// the push, the barrier and the row-wise work follow in turn. The FMA units
// and device memory are far from their limits.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "refusals.cuh"

namespace cg = cooperative_groups;

namespace {

#ifndef DDIM_THREADS
#define DDIM_THREADS 512
#endif

constexpr int NT = DDIM_THREADS;  // threads a CTA; a kernel may set DDIM_THREADS first
constexpr int NWARP = NT / 32;
constexpr int CLUSTER = 8;  // CTAs per cluster, the portable maximum

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

// Whether a width n splits over the cluster: as a product's output, each
// CTA's slice is whole float4 quads whose count divides a warp; as the next
// product's K, it splits into whole blocks of 4 k-rows for each of up to 16
// warps.
__host__ __device__ constexpr bool splits(int n) {
  return n > 0 && n % 64 == 0 && 32 % (n / (4 * CLUSTER)) == 0;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// Arrive without release semantics: for the barrier phase that only says a
// CTA is done reading buffers that others will write (every value it read
// has been consumed before the CTA's last __syncthreads).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fma4(float a, const float4& w, float4& acc) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}
__device__ __forceinline__ void fma_block(const float4& a, const float4 (&w)[4], float4& acc) {
  fma4(a.x, w[0], acc);
  fma4(a.y, w[1], acc);
  fma4(a.z, w[2], acc);
  fma4(a.w, w[3], acc);
}

// The left operand of a product group: rows of K floats in shared memory, row
// stride lda, 16-byte aligned; with a second part, columns k >= ksplit come
// from a2 (row stride lda2) at k - ksplit, which spares a copy for [x; skip].
struct Operand {
  const float *a, *a2;
  int lda, lda2, ksplit;
};
__device__ __forceinline__ Operand rows_of(const float* a, int lda) {
  return {a, a, lda, lda, 1 << 30};
}

// One product of a group: out = act(A W + bias) (+ res), W (K, N) row-major
// in device memory, out and the optional residual res in shared memory with
// row stride ldo. res may be out itself: each CTA reads its own copy of its
// own columns before it pushes them.
struct Product {
  const float* W;
  const float* bias;
  float* out;
  int N, ldo, act;
  const float* res;
};

constexpr int RPL_MAX = 4;  // rows a lane accumulates, at most

// How a product of output width n over nr rows spreads over a CTA. The
// slice is nq = n / CLUSTER / 4 float4 quads, so G = 32 / nq lanes of a warp
// share a quad; they split into RS row slots times G / RS k-slices, and the
// NWARP warps into RG row groups times NWARP / RG k-groups. RS, then RG, is
// the fewest (a power of 2) that leaves each lane at most RPL_MAX rows.
struct Split {
  int G, RS, RG;
  __host__ __device__ constexpr Split(int n, int nr)
      : G(32 / (n / (4 * CLUSTER))), RS(1), RG(1) {
    while (RS < G && RS * RPL_MAX < nr) RS <<= 1;
    while (RG < NWARP && RG * RS * RPL_MAX < nr) RG <<= 1;
  }
  __host__ __device__ constexpr int slots() const { return RS * RG; }  // rows in parallel
  __host__ __device__ constexpr int kgroups() const { return NWARP / RG; }
  __host__ __device__ constexpr int kslices() const { return G / RS; }
};

// Floats of the cross-warp partials (red) of a product of width n over nr rows.
__host__ __device__ constexpr int red_floats(int n, int nr) {
  return Split(n, nr).kgroups() * nr * (n / CLUSTER);
}

// acc[i] += A[row][k .. k + 4) w for the lane's rows r0 + i * slots (clamped to nr - 1).
template <int RPL>
__device__ __forceinline__ void fma_rows(const Operand& A, int k, int r0, int slots, int nr,
                                         const float4 (&w)[4], float4 (&acc)[RPL]) {
  const float* a = k < A.ksplit ? A.a + k : A.a2 + (k - A.ksplit);
  const int lda = k < A.ksplit ? A.lda : A.lda2;
#pragma unroll
  for (int i = 0; i < RPL; ++i) {
    const float* row = a + min(r0 + i * slots, nr - 1) * lda;
    fma_block(*reinterpret_cast<const float4*>(row), w, acc[i]);
  }
}

// This CTA's column slice of product p for the nr rows of A, pushed into p.out
// of every CTA of the cluster, spread as Split says. Lane (ks, rs, q) of a
// warp takes quad q, rows rs, rs + slots, ... of its warp's row group, and
// the blocks of 4 k-rows ks, ks + KS, ... of its warp's K-group, two blocks (8
// loads in flight) at a time; lanes of a quad that differ only in rs read the
// same weights. The k-slices meet by warp shuffles, the K-groups in red;
// thread t then finishes output quads t, t + NT, ... and pushes them.
// wait_free: wait for the group's first barrier phase before pushing.
template <int RPL>
__device__ __forceinline__ void slice_pass(const Operand& A, int K, const Product& p, float* red,
                                           int nr, bool wait_free) {
  cg::cluster_group cluster = cg::this_cluster();
  const Split sp(p.N, nr);
  const int nc = p.N / CLUSTER, nq = nc >> 2, n4 = p.N >> 2;
  const int KG = sp.kgroups(), KS = sp.kslices(), kw = K / KG, slots = sp.slots();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane / nq;
  const int q = lane % nq, kg = warp % KG, ks = g / sp.RS;
  const int r0 = warp / KG * sp.RS + g % sp.RS;
  const int c0 = (int)cluster.block_rank() * nc;
  // thread t finishes output quads t, t + NT, ... (row i / nq, quad i % nq);
  // the first one's bias is loaded now, under the weight stream
  const float4* bias4 = reinterpret_cast<const float4*>(p.bias + c0);
  const float4 b = __ldg(bias4 + tid % nq);
  const int k0 = kg * kw;
  const float4* W4 = reinterpret_cast<const float4*>(p.W) + (size_t)k0 * n4 + (c0 >> 2) + q;
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
  for (int o = nq * sp.RS; o < 32; o <<= 1)  // the k-slices of a quad
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
      if (r < nr) *reinterpret_cast<float4*>(red + (kg * nr + r) * nc + 4 * q) = acc[i];
    }
  __syncthreads();
  if (wait_free) cluster_wait();
  for (int it = tid; it < nr * nq; it += NT) {
    const int r = it / nq, qq = it % nq;
    float4 v = it == tid ? b : __ldg(bias4 + qq);
    for (int k = 0; k < KG; ++k) {
      const float4 u = *reinterpret_cast<const float4*>(red + (k * nr + r) * nc + 4 * qq);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    v = make_float4(activate(v.x, p.act), activate(v.y, p.act), activate(v.z, p.act),
                    activate(v.w, p.act));
    const int at = r * p.ldo + c0 + 4 * qq;
    if (p.res) {
      const float4 u = *reinterpret_cast<const float4*>(p.res + at);
      v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
    }
    float* dst = p.out + at;
#pragma unroll
    for (int d = 0; d < CLUSTER; ++d)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, d)) = v;
  }
}

// The M products ps over the same R rows of A (K wide), as one cluster step:
// on return every CTA of the cluster holds all R rows of every product. All
// threads of every CTA call it.
template <int M>
__device__ void cluster_dense(const Operand& A, int K, const Product (&ps)[M], float* red,
                              int R) {
  cluster_arrive_relaxed();  // this CTA is done with the outputs: the others may push into them
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int rpl = (R + Split(ps[m].N, R).slots() - 1) / Split(ps[m].N, R).slots();
    if (rpl <= 1)
      slice_pass<1>(A, K, ps[m], red, R, m == 0);
    else if (rpl == 2)
      slice_pass<2>(A, K, ps[m], red, R, m == 0);
    else
      slice_pass<RPL_MAX>(A, K, ps[m], red, R, m == 0);
  }
  cluster_arrive();  // every push of this CTA is done
  cluster_wait();
}

// out = LayerNorm(in) * g + b over D for `rows` rows (eps 1e-5), one warp per
// row; in and out may alias.
template <int D>
__device__ void layernorm(const float* in, float* out, const float* __restrict__ g,
                          const float* __restrict__ b, int rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += NWARP) {
    const float* x = in + r * D;
    float s = 0.f;
#pragma unroll
    for (int c = lane; c < D; c += 32) s += x[c];
    const float mean = warp_sum(s) / D;
    float v = 0.f;
#pragma unroll
    for (int c = lane; c < D; c += 32) {
      const float d = x[c] - mean;
      v += d * d;
    }
    const float inv = rsqrtf(warp_sum(v) / D + 1e-5f);
#pragma unroll
    for (int c = lane; c < D; c += 32) out[r * D + c] = (x[c] - mean) * inv * g[c] + b[c];
  }
  __syncthreads();
}

template <int D>
__device__ __forceinline__ float dot_warp(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int c = threadIdx.x & 31; c < D; c += 32) s = fmaf(a[c], b[c], s);
  return warp_sum(s);
}

// A launch of `clusters` clusters of CLUSTER CTAs of NT threads, each with
// `smem` bytes of dynamic shared memory, on `stream`.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;

  ClusterLaunch(int clusters, size_t smem, void* stream) : config() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3(clusters * CLUSTER);
    config.blockDim = dim3(NT);
    config.dynamicSmemBytes = smem;
    config.stream = static_cast<cudaStream_t>(stream);
    config.attrs = attr;
    config.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;

  template <typename Kernel>
  cudaError_t setup(Kernel* kernel) const {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)config.dynamicSmemBytes);
  }

  // Clusters of this launch that fit on the card at once.
  template <typename Kernel>
  cudaError_t active(Kernel* kernel, int* n) const {
    cudaError_t err = setup(kernel);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(n, kernel, &config);
  }

  // info: CTAs per cluster, CTAs in the grid, clusters that fit on the card
  // at once (cudaOccupancyMaxActiveClusters), dynamic shared memory bytes.
  template <typename Kernel>
  cudaError_t describe(Kernel* kernel, int* info) const {
    int fit = 0;
    const cudaError_t err = active(kernel, &fit);
    info[0] = CLUSTER;
    info[1] = (int)config.gridDim.x;
    info[2] = fit;
    info[3] = (int)config.dynamicSmemBytes;
    return err;
  }
};

// Samples a cluster carries: enough that B samples fit on the card in one wave
// of `fit` clusters, at least 1 and at most `most`.
inline int samples_per_cluster(int B, int fit, int most) {
  const int spc = (B + (fit > 0 ? fit : 1) - 1) / (fit > 0 ? fit : 1);
  return spc < 1 ? 1 : (spc > most ? most : spc);
}

}  // namespace
