// EgoHMR's reverse process: one modulated graph conv a launch, CUDA C++ for sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves the GCN to XLA
// (`seeme_tpu/nn/gcn.py`). Added because the port's eager step ran about 200
// launches and two blocking host copies a step, and its products in f32 off
// the tensor cores (PERF.md). A step of `models/egohmr.py::EgoHmr.sample` is
// 2 x gcn_layers + 2 launches over the 2B x 24 joint rows of the conditioned
// and the scene-only branch (`ops/gcn_fused.py` makes every operand):
//
//   gcn_input   one thread a (sample, channel): the input conv's h0, h1 from
//               the parts hoisted out of the step (vis_j P_img + P_rest + the
//               step's timestep row + x W_x, the pose embedding folded into
//               the conv, six f32 FMAs), then the graph conv's epilogue;
//   gcn_conv    a hidden conv: the (rows x K) activations times the packed
//               (K x 2H) weights on wgmma, then the epilogue;
//   gcn_output  one CTA a sample: both branches' 48 rows x H -> 2 x 6 in f32
//               FMAs, the adjacency mix and bias, the fusion by visibility
//               and the ancestral update from the step's coefficients.
//
// The graph conv's epilogue, in f32: out_j = A_jj M_j h0_j + sum_k A'_jk M_k
// h1_k (A' the off-diagonal half of the symmetrized adjacency), then the
// bias and frozen batch norm folded into one scale and shift, ReLU, and the
// block's residual; it writes f32 rows where a residual will read them and
// the tf32 hi/lo pair the next conv's products read.
//
// What bounds gcn_conv on the H100: operations. A hidden conv at B = 64 is
// 3072 rows x 1024 x 2048 multiply-adds, 12.9 GFLOP, against 16 MB of split
// weights and 25 MB of split activations. The cell holds the final pose to
// 1e-4 of the f32 reference (joints and vertices to 2e-4), and one bf16 or
// TF32 pass over 50 steps misses that by far. So each product runs as three
// TF32 products of split operands (a = hi + lo, hi = tf32(a), lo = tf32(a -
// hi), both rounded to nearest: hi hi + hi lo + lo hi), and the tensor
// cores' sums are kept short: they add into their accumulator rounding
// toward zero, a bias that over a conv's 384 products of one accumulator
// reached 1e-5 of |out| and outweighed either split scheme's own error.
// Each warpgroup runs CHUNK K steps into a fresh accumulator, keeping their
// products in flight, and adds it to an f32 sum rounded to nearest. One
// pass of the GCN then reads 1.0e-6 of its f32 version, against 9.9e-6 for
// split bf16 and 1.7e-5 for split TF32 with one accumulator; split bf16
// read the cell's pose up to 5.5e-5 and its joints up to 1.4e-4 (PERF.md).
// The scheme's floor is three products at the TF32 rate, 78 us a conv.
//
// gcn_conv's design. A CTA takes TM = 192 rows (8 whole samples, so the
// 24-joint mix never leaves the CTA) by TC = 64 channels, 128 packed columns
// (h0 | h1 of the same channels): three consumer warpgroups each own 64 rows
// in m64n128k8 products (64 accumulator registers a thread, and 64 for the
// partial); one thread of a producer warpgroup streams K steps of 8 through
// a ring of STAGES slots, each slot the A rows (hi over lo, 12 KB) and the B
// columns (hi over lo, 8 KB), both by TMA bulk copies of contiguous slot
// images in wgmma's 32-byte swizzle: the weights laid out once
// (`gcn_fused.pack_weight`), the activations by the previous conv's
// epilogue. A warpgroup frees a chunk's slots once the chunk's products are
// done; the ring holds two chunks. The epilogue moves the accumulators
// through shared memory (the ring, free by then) so that one thread holds a
// (sample, channel)'s 24 joints. At B = 64, H = 1024: 16 x 16 = 256 CTAs,
// 165 KB of shared memory each, two waves on 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "refusals.cuh"

namespace {

constexpr int J = 24;                      // SMPL joints: the rows of one sample
constexpr int SAMPLES = 8;                 // samples a row tile
constexpr int TM = J * SAMPLES;            // rows a tile: three wgmma row blocks of 64
constexpr int TC = GCN_CHANNELS;           // channels a CTA
constexpr int TN = 2 * TC;                 // packed columns a CTA: h0 then h1
constexpr int KS = 8;                      // K of one ring slot: one tf32 wgmma step, 32 bytes
constexpr int CONSUMERS = 3;               // wgmma warpgroups, 64 rows each
constexpr int NT = 128 * (CONSUMERS + 1);  // and a producer warpgroup (one thread works)
constexpr int STAGES = 8;
constexpr int CHUNK = 4;                   // K steps a partial accumulator takes
constexpr int A_SLOT = 2 * TM * KS * 4;    // hi rows over lo rows, f32 holding tf32
constexpr int B_SLOT = 2 * TN * KS * 4;
constexpr int STAGE = A_SLOT + B_SLOT;
constexpr int RING = STAGES * STAGE;
constexpr int SCR_LD = TN + 8;             // floats a row of the epilogue's scratch
constexpr int ADJ = RING;                  // off-diagonal (J x J), then the diagonal (J)
constexpr int ADJ_FLOATS = J * J + J;
constexpr int BARS = ADJ + ADJ_FLOATS * 4;  // full[STAGES], then empty[STAGES]
constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;  // + 1024-byte alignment
constexpr int IN_SAMPLES = 4;              // gcn_input: samples a block, TC channels each
static_assert(TM % 64 == 0 && TM / 64 == CONSUMERS, "a warpgroup a 64-row block");
static_assert(TC % (KS * CHUNK) == 0 && STAGES >= 2 * CHUNK, "whole chunks, one ahead in the ring");
static_assert(TM * SCR_LD * 4 <= RING, "the epilogue's scratch in the ring");
static_assert(STAGE % 1024 == 0 && A_SLOT % 256 == 0, "slots at swizzle-atom boundaries");
static_assert(BARS % 8 == 0 && BYTES <= 232448, "shared memory of one CTA");
static_assert(GCN_CHANNELS % 4 == 0, "gcn_output reads rows four floats at a time");

struct ConvParams {
  const uint8_t* a;     // activations, tiled (`gcn_fused.py::tile_rows`): (tiles, K/8, 2 TM, 8)
  const uint8_t* w;     // packed weights: (H / TC, K / 8, 2 TN, 8)
  const float* m;       // M (J, H)
  const float* adj;     // off-diagonal (J, J), then the diagonal (J)
  const float* scale;   // (H): the batch norm's scale
  const float* shift;   // (H): its shift with the conv's bias folded in
  const float* resid;   // (rows, H) f32, added after the ReLU, or null
  float* out_f32;       // (rows, H), or null
  uint8_t* out_hl;      // tiled like `a`
  int H;                // the width in and out
};

struct InputParams {
  const float* x;       // (B, J * 6) the state
  const float* vis;     // (B, J) 1 where the joint is visible
  const float* p_img;   // (B, 2, H): the image block's share, taken by the conditioned rows
  const float* p_rest;  // (2B, 2, H): the rest of the condition's share, each branch's
  const float* trow;    // (2, H): the step's timestep share with the embedding's bias
  const float* wx;      // (6, 2, H): the pose embedding folded into the conv
  const float* m;
  const float* adj;
  const float* scale;
  const float* shift;
  float* out_f32;       // (rows, H)
  uint8_t* out_hl;
  int B, H;
};

struct OutputParams {
  const float* xf;      // (rows, H): the last residual block's output
  const float* w;       // (H, 12): W[0] then W[1], six columns each
  const float* m;       // (J, 6)
  const float* adj;
  const float* bias;    // (6)
  const float* vis;     // (B, J)
  const float* x;       // (B, J * 6) the state x_t
  const float* eps;     // (B, J * 6) the step's noise, or null
  const float* coef;    // the step's [x0, x_t, noise] coefficients, or null: write the prediction
  float* out;           // (B, J * 6)
  int B, H;
};

// ---- PTX helpers (as csrc/pointnet.cu has them)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of `bar` with this parity. A launch takes microseconds,
// so a wait of seconds is a stuck pipeline: trap, and the launch fails
// instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!bar_try(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A TMA bulk copy of `bytes` from device memory into this CTA's shared
// memory at `dst`, completing bytes on the barrier at `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major operand in the 32-byte swizzle: rows of 8
// tf32 (32 bytes), 8-row groups 256 bytes apart, LBO unused (one K step
// spans the swizzle width); the operand starts at a 256-byte boundary.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (16ull << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across the asynchronous
// products' issue and wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC64 ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56)
#define D_REGS64                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "  \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A B for a 64 x 8 A and an 8 x 128 B, both K-major in shared memory
// (m64n128k8, tf32 inputs, f32 accumulation); d += when acc != 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, uint32_t acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " D_REGS64
      ", %64, %65, p, 1, 1;\n\t}"
      : ACC64
      : "l"(a), "l"(b), "r"(acc));
}

// x rounded to TF32's 10 mantissa bits, to nearest even, as an f32 (the
// tensor cores read the top 19 bits): `split_precision.py::_tf32` bitwise.
__device__ __forceinline__ float tf32(float x) {
  const uint32_t i = __float_as_uint(x);
  return __uint_as_float((i + 0xFFFu + ((i >> 13) & 1u)) & 0xFFFFE000u);
}

// ---- the graph conv's epilogue

// y as the next conv's A operand: its tf32 pair (hi, lo) at row r, channel
// ch of the row tile `tile` (`gcn_fused.py::tile_rows`): K step ch / 8 is a
// slot image of TM hi rows then TM lo rows of 32 bytes, the two 16-byte
// halves of a row swapped where bit 2 of the row is set.
__device__ __forceinline__ void store_hl(uint8_t* tile, int r, int ch, float y) {
  const int kk = ch & 7;
  const int chunk = (kk >> 2) ^ ((r >> 2) & 1);
  float* p = reinterpret_cast<float*>(tile + (size_t)(ch >> 3) * A_SLOT + r * 32 + chunk * 16) +
             (kk & 3);
  const float hi = tf32(y);
  p[0] = hi;
  p[TM * 8] = tf32(y - hi);
}

// One (sample, channel)'s 24 joints: h0, h1 in, the mix, scale and shift,
// ReLU and residual, then the stores. `row0` is the sample's first row among
// all rows, `r0` among its tile's; `adj` in shared memory.
__device__ __forceinline__ void epilogue(float (&h0)[J], float (&h1)[J], int ch, const float* m,
                                         const float* adj, float scale, float shift,
                                         const float* resid, float* out_f32, uint8_t* tile,
                                         size_t row0, int r0, int H) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float mj = __ldg(m + j * H + ch);
    h0[j] *= mj;
    h1[j] *= mj;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    float o = adj[J * J + j] * h0[j];
#pragma unroll
    for (int k = 0; k < J; ++k) o = fmaf(adj[j * J + k], h1[k], o);
    float y = fmaxf(fmaf(scale, o, shift), 0.f);
    const size_t at = (row0 + j) * H + ch;
    if (resid) y += resid[at];
    if (out_f32) out_f32[at] = y;
    store_hl(tile, r0 + j, ch, y);
  }
}

// ---- gcn_conv

__device__ __forceinline__ void produce(const ConvParams& p, uint32_t base, uint32_t bars) {
  const int steps = p.H / KS;
  const uint8_t* a = p.a + (size_t)blockIdx.y * steps * A_SLOT;
  const uint8_t* w = p.w + (size_t)blockIdx.x * steps * B_SLOT;
  int stage = 0;
  uint32_t phase = 0;
  for (int s = 0; s < steps; ++s) {
    bar_wait(bars + 8 * (STAGES + stage), phase ^ 1);
    bar_expect_tx(bars + 8 * stage, STAGE);
    bulk_load(base + stage * STAGE, a + (size_t)s * A_SLOT, A_SLOT, bars + 8 * stage);
    bulk_load(base + stage * STAGE + A_SLOT, w + (size_t)s * B_SLOT, B_SLOT, bars + 8 * stage);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// acc = this warpgroup's 64 rows times the CTA's 128 packed columns, three
// products a K step (hi hi, hi lo, lo hi), each CHUNK steps into `part` and
// then onto acc in f32.
__device__ __forceinline__ void consume(const ConvParams& p, float (&acc)[64], uint32_t base,
                                       uint32_t bars, int wg, int wt) {
  const int steps = p.H / KS;
  int stage = 0;
  uint32_t phase = 0;
  float part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  fence_acc(acc);
#pragma unroll 1
  for (int s = 0; s < steps; s += CHUNK) {
    const int first = stage;
#pragma unroll
    for (int c = 0; c < CHUNK; ++c) {
      bar_wait(bars + 8 * stage, phase);
      const uint32_t a = base + stage * STAGE + wg * 64 * 32;
      const uint32_t b = base + stage * STAGE + A_SLOT;
      wgmma_fence();
      wgmma_ss(part, desc_sw32(a), desc_sw32(b), c > 0);
      wgmma_ss(part, desc_sw32(a), desc_sw32(b + TN * 32), 1u);
      wgmma_ss(part, desc_sw32(a + TM * 32), desc_sw32(b), 1u);
      wgmma_commit();
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();  // the chunk's products are done: free its slots, fold it in
    fence_acc(part);
    if (wt == 0) {
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) bar_arrive(bars + 8 * (STAGES + (first + c) % STAGES));
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
  fence_acc(acc);
}

// Launched at 128 registers a thread; the producer warpgroup gives up all but
// 32 so that each consumer thread holds 160, its accumulator and partial 128
// of them (each SM quarter runs one warp of every warpgroup: 3 x 160 + 32 =
// 512 registers a lane).
__global__ void __launch_bounds__(NT, 1) gcn_conv_kernel(const ConvParams p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + BARS;
  float* adj = reinterpret_cast<float*>(smem + ADJ);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(bars + 8 * s, 1);                        // the producer's arrive + bytes
      bar_init(bars + 8 * (STAGES + s), CONSUMERS);     // one arrive a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < ADJ_FLOATS; i += NT) adj[i] = p.adj[i];
  __syncthreads();
  if (tid >= 128 * CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;" ::: "memory");
    if (tid == 128 * CONSUMERS) produce(p, base, bars);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;" ::: "memory");
  const int wg = tid >> 7, wt = tid & 127, w = wt >> 5, g = (tid & 31) >> 2, c = tid & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  consume(p, acc, base, bars, wg, wt);
  named_sync(1, 128 * CONSUMERS);  // every warpgroup done with the ring: it is scratch now
  float* scr = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < TN / 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wg * 64 + 16 * w + g + 8 * r;
      *reinterpret_cast<float2*>(scr + row * SCR_LD + 8 * i + 2 * c) =
          make_float2(acc[4 * i + 2 * r], acc[4 * i + 2 * r + 1]);
    }
  named_sync(1, 128 * CONSUMERS);
  uint8_t* tile = p.out_hl + (size_t)blockIdx.y * (p.H / KS) * A_SLOT;
  for (int item = tid; item < SAMPLES * TC; item += 128 * CONSUMERS) {
    const int s = item / TC, cl = item % TC, ch = blockIdx.x * TC + cl;
    float h0[J], h1[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      h0[j] = scr[(s * J + j) * SCR_LD + cl];
      h1[j] = scr[(s * J + j) * SCR_LD + TC + cl];
    }
    epilogue(h0, h1, ch, p.m, adj, __ldg(p.scale + ch), __ldg(p.shift + ch), p.resid, p.out_f32,
             tile, (size_t)blockIdx.y * TM + s * J, s * J, p.H);
  }
}

// ---- gcn_input: block (TC channels, IN_SAMPLES samples), one thread a pair

__global__ void __launch_bounds__(TC* IN_SAMPLES) gcn_input_kernel(const InputParams p) {
  __shared__ float adj[ADJ_FLOATS];
  for (int i = threadIdx.x; i < ADJ_FLOATS; i += blockDim.x) adj[i] = p.adj[i];
  __syncthreads();
  const int cl = threadIdx.x % TC, sl = threadIdx.x / TC;
  const int s = blockIdx.y * IN_SAMPLES + sl, ch = blockIdx.x * TC + cl, H = p.H;
  float h0[J], h1[J];
  if (s < 2 * p.B) {  // samples past 2B pad the last row tile: zero in, never read out
    const bool cond = s < p.B;
    const int b = cond ? s : s - p.B;
    float base[2], img[2], wx[2][6];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      base[k] = p.p_rest[((size_t)s * 2 + k) * H + ch] + p.trow[k * H + ch];
      img[k] = cond ? p.p_img[((size_t)b * 2 + k) * H + ch] : 0.f;
#pragma unroll
      for (int d = 0; d < 6; ++d) wx[k][d] = __ldg(p.wx + (d * 2 + k) * H + ch);
    }
    const float* x = p.x + (size_t)b * J * 6;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float v = cond ? p.vis[(size_t)b * J + j] : 0.f;
      float e[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float acc = fmaf(v, img[k], base[k]);
#pragma unroll
        for (int d = 0; d < 6; ++d) acc = fmaf(x[j * 6 + d], wx[k][d], acc);
        e[k] = acc;
      }
      h0[j] = e[0];
      h1[j] = e[1];
    }
  } else {
#pragma unroll
    for (int j = 0; j < J; ++j) h0[j] = h1[j] = 0.f;
  }
  const int tile = s / SAMPLES;
  epilogue(h0, h1, ch, p.m, adj, __ldg(p.scale + ch), __ldg(p.shift + ch), nullptr, p.out_f32,
           p.out_hl + (size_t)tile * (H / KS) * A_SLOT, (size_t)s * J, (s % SAMPLES) * J, H);
}

// ---- gcn_output: one CTA a sample, 8 warps

constexpr int OUT_THREADS = 256;
constexpr int OUT_ROWS = 2 * J / (OUT_THREADS / 32);  // rows a warp: the k loop serves them all

__global__ void __launch_bounds__(OUT_THREADS) gcn_output_kernel(const OutputParams p) {
  __shared__ float adj[ADJ_FLOATS];
  __shared__ float h[2 * J][12];     // each row's h0 (6) and h1 (6): the conditioned rows first
  __shared__ float pred[2][J * 6];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, b = blockIdx.x, H = p.H;
  for (int i = tid; i < ADJ_FLOATS; i += OUT_THREADS) adj[i] = p.adj[i];
  // warp w takes rows w, w + 8, ...; each lane four columns a pass, each W row read
  // once a warp for all its rows, so that a pass has 6 + 12 loads in flight
  const float* xr[OUT_ROWS];
#pragma unroll
  for (int i = 0; i < OUT_ROWS; ++i) {
    const int r = warp + 8 * i, branch = r / J, j = r % J;
    xr[i] = p.xf + ((size_t)(branch * p.B + b) * J + j) * H;
  }
  float acc[OUT_ROWS][12] = {};
  for (int k0 = 4 * lane; k0 < H; k0 += 128) {
    float4 xv[OUT_ROWS];
#pragma unroll
    for (int i = 0; i < OUT_ROWS; ++i) xv[i] = *reinterpret_cast<const float4*>(xr[i] + k0);
    const float4* wr = reinterpret_cast<const float4*>(p.w + (size_t)k0 * 12);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 wv = __ldg(wr + 3 * e + q);
#pragma unroll
        for (int i = 0; i < OUT_ROWS; ++i) {
          const float xe = e == 0 ? xv[i].x : e == 1 ? xv[i].y : e == 2 ? xv[i].z : xv[i].w;
          acc[i][4 * q] = fmaf(xe, wv.x, acc[i][4 * q]);
          acc[i][4 * q + 1] = fmaf(xe, wv.y, acc[i][4 * q + 1]);
          acc[i][4 * q + 2] = fmaf(xe, wv.z, acc[i][4 * q + 2]);
          acc[i][4 * q + 3] = fmaf(xe, wv.w, acc[i][4 * q + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < OUT_ROWS; ++i) {
#pragma unroll
    for (int c = 0; c < 12; ++c) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], s);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 12; ++c) h[warp + 8 * i][c] = acc[i][c];
    }
  }
  __syncthreads();
  for (int item = tid; item < 2 * J * 6; item += OUT_THREADS) {
    const int branch = item / (J * 6), j = item % (J * 6) / 6, d = item % 6;
    float o = adj[J * J + j] * (p.m[j * 6 + d] * h[branch * J + j][d]);
#pragma unroll 4
    for (int k = 0; k < J; ++k) o = fmaf(adj[j * J + k], p.m[k * 6 + d] * h[branch * J + k][6 + d], o);
    pred[branch][j * 6 + d] = o + p.bias[d];
  }
  __syncthreads();
  if (tid < J * 6) {
    const size_t at = (size_t)b * J * 6 + tid;
    const float v = p.vis[(size_t)b * J + tid / 6] > 0.5f ? pred[0][tid] : pred[1][tid];
    if (!p.coef) {
      p.out[at] = v;
    } else {
      float y = p.coef[0] * v + p.coef[1] * p.x[at];
      if (p.eps) y += p.coef[2] * p.eps[at];
      p.out[at] = y;
    }
  }
}

int widths(int H) { return (H <= 0 || H % TC) ? REFUSE_GCN_WIDTH : 0; }

}  // namespace

// The launchers' width check: 0, or the refusal of a hidden width that is not
// a multiple of GCN_CHANNELS.
extern "C" int gcn_widths(int H) { return widths(H); }

// One hidden graph conv over `tiles` row tiles of 8 samples; a, out_hl as
// `gcn_fused.py::tile_rows` lays them out, w as `pack_weight`.
extern "C" int gcn_conv(const void* a, const void* w, const float* m, const float* adj,
                        const float* scale, const float* shift, const float* resid,
                        float* out_f32, void* out_hl, int tiles, int H, void* stream) {
  if (int err = widths(H)) return err;
  const ConvParams p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(w), m, adj,
                     scale, shift, resid, out_f32, static_cast<uint8_t*>(out_hl), H};
  cudaError_t err =
      cudaFuncSetAttribute(gcn_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (err != cudaSuccess) return err;
  gcn_conv_kernel<<<dim3(H / TC, tiles), NT, BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The input conv of B samples' two branches (2B, padded to whole row tiles).
extern "C" int gcn_input(const float* x, const float* vis, const float* p_img,
                         const float* p_rest, const float* trow, const float* wx, const float* m,
                         const float* adj, const float* scale, const float* shift, float* out_f32,
                         void* out_hl, int B, int H, void* stream) {
  if (int err = widths(H)) return err;
  const InputParams p{x, vis, p_img, p_rest, trow, wx, m, adj, scale, shift, out_f32,
                      static_cast<uint8_t*>(out_hl), B, H};
  const int tiles = (2 * B + SAMPLES - 1) / SAMPLES;
  gcn_input_kernel<<<dim3(H / TC, tiles * SAMPLES / IN_SAMPLES), TC * IN_SAMPLES, 0,
                     static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

// The output conv, the fusion by visibility and, given `coef`, the update.
extern "C" int gcn_output(const float* xf, const float* w, const float* m, const float* adj,
                          const float* bias, const float* vis, const float* x, const float* eps,
                          const float* coef, float* out, int B, int H, void* stream) {
  if (int err = widths(H)) return err;
  const OutputParams p{xf, w, m, adj, bias, vis, x, eps, coef, out, B, H};
  gcn_output_kernel<<<B, OUT_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
