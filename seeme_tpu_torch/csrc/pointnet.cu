// Fused PointNet residual blocks for the scene encoder, CUDA C++ for sm_90a.
//
// Replaces the TPU kernels `seeme_tpu/ops/pointnet_pallas.py::fused_input_block`
// (`_input_kernel`) and `::fused_split_block` (`_block_kernel`).
//
//   input block:  h   = pts W_pos + b_pos                      (3 -> 2H)
//                 net = relu(h) W_0 + b_0                      (2H -> H)
//                 out = h W_s + relu(net) W_1 + b_1            (2H -> H, H -> H)
//   split block:  net = relu(x) W_0x + c0                      (c0 = relu(pooled) W_0p + b_0)
//                 out = x W_sx + relu(net) W_1 + cs            (cs = pooled W_sp + b_1)
//
// Both also write the column max of their tile of points; the wrapper reduces
// the tiles to the per-batch pool with one amax.
//
// What bounds it on the H100: operations. About 3.7 M multiply-adds per point
// over the four blocks, 9.4 TFLOP per encode of 64 x 20 000 points, against
// 2.6 GB per (B, N, 512) f32 activation buffer: far above the card's
// operations-per-byte line, so the tensor cores (not HBM) are the limit of a
// fast version.
//
// This first design does the products in f32 on the FMA units, which caps it
// at the 67 TFLOP/s f32 rate. One CTA of 256 threads takes 32 points of one
// batch row. The tile's activations stay in shared memory (the input block's
// (32, 2H) embedding is 128 KB; the TPU kernel's (512, 2H) tile would be 2 MB
// and does not fit), so only x and out cross device memory. Weights stream
// through shared memory in chunks of 8 rows, the next chunk prefetched into
// registers while the current one is used. Each thread accumulates an 8-row by
// H/64-column block. The point count need not divide the tile: the last tile
// is masked. Only H = 512, the EgoBody scene encoder's width, is instantiated.
// bf16 operands on wgmma are the next step.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 32;   // points per CTA
constexpr int KC = 8;    // weight rows per shared-memory chunk
constexpr int NT = 256;  // threads: 4 row groups (8 rows each) x 64 column groups

// acc[i][c] holds row ty*8 + i, column (c / 4) * 256 + tx * 4 + c % 4.
__device__ __forceinline__ int col_of(int c, int tx) { return (c >> 2) * 256 + tx * 4 + (c & 3); }

// acc += op(A) W for the CTA's TM rows; A is (TM, K) in shared memory with row
// stride lda, W is (K, H) row-major in device memory, op = relu when RELU_A.
template <int H, bool RELU_A>
__device__ __forceinline__ void gemm_acc(const float* As, int lda, int K,
                                         const float* __restrict__ W, float* wbuf,
                                         float (&acc)[8][H / 64]) {
  constexpr int G = H / 256;
  constexpr int LOADS = KC * H / 4 / NT;
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  const float4* W4 = reinterpret_cast<const float4*>(W);
  float4 pre[LOADS];
#pragma unroll
  for (int l = 0; l < LOADS; ++l) pre[l] = __ldg(W4 + tid + l * NT);
  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();
#pragma unroll
    for (int l = 0; l < LOADS; ++l) reinterpret_cast<float4*>(wbuf)[tid + l * NT] = pre[l];
    __syncthreads();
    if (k0 + KC < K) {
      const float4* nxt = W4 + (size_t)(k0 + KC) * (H / 4);
#pragma unroll
      for (int l = 0; l < LOADS; ++l) pre[l] = __ldg(nxt + tid + l * NT);
    }
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = As[(ty * 8 + i) * lda + k0 + kk];
        a[i] = RELU_A ? fmaxf(v, 0.f) : v;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 b = *reinterpret_cast<const float4*>(wbuf + kk * H + g * 256 + tx * 4);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][g * 4 + 0] = fmaf(a[i], b.x, acc[i][g * 4 + 0]);
          acc[i][g * 4 + 1] = fmaf(a[i], b.y, acc[i][g * 4 + 1]);
          acc[i][g * 4 + 2] = fmaf(a[i], b.z, acc[i][g * 4 + 2]);
          acc[i][g * 4 + 3] = fmaf(a[i], b.w, acc[i][g * 4 + 3]);
        }
      }
    }
  }
  __syncthreads();
}

template <int H>
__device__ __forceinline__ void zero_acc(float (&acc)[8][H / 64]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < H / 64; ++c) acc[i][c] = 0.f;
}

// ns = relu(acc + bias): the hidden activation the next product reads.
template <int H>
__device__ __forceinline__ void store_hidden(float (&acc)[8][H / 64],
                                             const float* __restrict__ bias, float* ns) {
  const int tx = threadIdx.x & 63, ty = threadIdx.x >> 6;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < H / 64; ++c) {
      const int col = col_of(c, tx);
      ns[(ty * 8 + i) * H + col] = fmaxf(acc[i][c] + bias[col], 0.f);
    }
}

// out rows = acc + bias for the tile's valid rows, and the tile's column max.
template <int H>
__device__ __forceinline__ void store_out(float (&acc)[8][H / 64],
                                          const float* __restrict__ bias, float* out,
                                          float* tile_max, int rows, float* scratch) {
  constexpr int G = H / 256;
  const int tid = threadIdx.x, tx = tid & 63, ty = tid >> 6;
  float m[H / 64];
#pragma unroll
  for (int c = 0; c < H / 64; ++c) m[c] = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty * 8 + i;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int col = g * 256 + tx * 4;
      float4 v;
      v.x = acc[i][g * 4 + 0] + bias[col + 0];
      v.y = acc[i][g * 4 + 1] + bias[col + 1];
      v.z = acc[i][g * 4 + 2] + bias[col + 2];
      v.w = acc[i][g * 4 + 3] + bias[col + 3];
      if (r < rows) {
        *reinterpret_cast<float4*>(out + (size_t)r * H + col) = v;
        m[g * 4 + 0] = fmaxf(m[g * 4 + 0], v.x);
        m[g * 4 + 1] = fmaxf(m[g * 4 + 1], v.y);
        m[g * 4 + 2] = fmaxf(m[g * 4 + 2], v.z);
        m[g * 4 + 3] = fmaxf(m[g * 4 + 3], v.w);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < H / 64; ++c) scratch[ty * H + col_of(c, tx)] = m[c];
  __syncthreads();
  for (int c = tid; c < H; c += NT)
    tile_max[c] = fmaxf(fmaxf(scratch[c], scratch[H + c]),
                        fmaxf(scratch[2 * H + c], scratch[3 * H + c]));
}

template <int H>
__global__ void __launch_bounds__(NT, 1)
input_block_kernel(const float* __restrict__ pts, const float* __restrict__ wpos,
                   const float* __restrict__ bpos, const float* __restrict__ w0,
                   const float* __restrict__ b0, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ ws,
                   float* __restrict__ out, float* __restrict__ tile_max, int N) {
  constexpr int H2 = 2 * H;
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;             // (TM, 2H) point embedding
  float* ns = hs + TM * H2;     // (TM, H) relu(net)
  float* wbuf = ns + TM * H;    // (KC, H) weight chunk; column-max scratch at the end
  float* ps = wbuf + KC * H;    // (TM, 3) points
  const int b = blockIdx.y, row0 = blockIdx.x * TM, tid = threadIdx.x;
  const int rows = min(TM, N - row0);

  for (int i = tid; i < TM * 3; i += NT)
    ps[i] = (i / 3) < rows ? pts[((size_t)b * N + row0) * 3 + i] : 0.f;
  __syncthreads();
  for (int i = tid; i < TM * H2; i += NT) {
    const int r = i / H2, c = i - r * H2;
    const float* p = ps + r * 3;
    hs[i] = fmaf(p[2], wpos[2 * H2 + c], fmaf(p[1], wpos[H2 + c], p[0] * wpos[c])) + bpos[c];
  }

  float acc[8][H / 64];
  zero_acc<H>(acc);
  gemm_acc<H, true>(hs, H2, H2, w0, wbuf, acc);
  store_hidden<H>(acc, b0, ns);
  zero_acc<H>(acc);
  gemm_acc<H, false>(hs, H2, H2, ws, wbuf, acc);
  gemm_acc<H, false>(ns, H, H, w1, wbuf, acc);
  store_out<H>(acc, b1, out + ((size_t)b * N + row0) * H,
               tile_max + ((size_t)b * gridDim.x + blockIdx.x) * H, rows, wbuf);
}

template <int H>
__global__ void __launch_bounds__(NT, 1)
split_block_kernel(const float* __restrict__ x, const float* __restrict__ c0,
                   const float* __restrict__ cs, const float* __restrict__ w0x,
                   const float* __restrict__ w1, const float* __restrict__ wsx,
                   float* __restrict__ out, float* __restrict__ tile_max, int N) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // (TM, H) block input
  float* ns = xs + TM * H;     // (TM, H) relu(net)
  float* wbuf = ns + TM * H;   // (KC, H)
  const int b = blockIdx.y, row0 = blockIdx.x * TM, tid = threadIdx.x;
  const int rows = min(TM, N - row0);

  const float4* x4 = reinterpret_cast<const float4*>(x + ((size_t)b * N + row0) * H);
  for (int i = tid; i < TM * H / 4; i += NT)
    reinterpret_cast<float4*>(xs)[i] =
        (i / (H / 4)) < rows ? __ldg(x4 + i) : make_float4(0.f, 0.f, 0.f, 0.f);

  float acc[8][H / 64];
  zero_acc<H>(acc);
  gemm_acc<H, true>(xs, H, H, w0x, wbuf, acc);
  store_hidden<H>(acc, c0 + (size_t)b * H, ns);
  zero_acc<H>(acc);
  gemm_acc<H, false>(xs, H, H, wsx, wbuf, acc);
  gemm_acc<H, false>(ns, H, H, w1, wbuf, acc);
  store_out<H>(acc, cs + (size_t)b * H, out + ((size_t)b * N + row0) * H,
               tile_max + ((size_t)b * gridDim.x + blockIdx.x) * H, rows, wbuf);
}

// Dynamic shared memory above 48 KB has to be allowed per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" int pointnet_input_block(const float* pts, const float* wpos, const float* bpos,
                                    const float* w0, const float* b0, const float* w1,
                                    const float* b1, const float* ws, float* out,
                                    float* tile_max, int B, int N, int H, void* stream) {
  const dim3 grid((N + TM - 1) / TM, B);
  const size_t smem = (size_t)(TM * 2 * H + TM * H + KC * H + TM * 3) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (H == 512) {
    if ((err = allow_smem(input_block_kernel<512>, smem)) != cudaSuccess) return err;
    input_block_kernel<512><<<grid, NT, smem, s>>>(pts, wpos, bpos, w0, b0, w1, b1, ws, out,
                                                   tile_max, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" int pointnet_split_block(const float* x, const float* c0, const float* cs,
                                    const float* w0x, const float* w1, const float* wsx,
                                    float* out, float* tile_max, int B, int N, int H,
                                    void* stream) {
  const dim3 grid((N + TM - 1) / TM, B);
  const size_t smem = (size_t)(2 * TM * H + KC * H) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (H == 512) {
    if ((err = allow_smem(split_block_kernel<512>, smem)) != cudaSuccess) return err;
    split_block_kernel<512><<<grid, NT, smem, s>>>(x, c0, cs, w0x, w1, wsx, out, tile_max, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* seeme_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
