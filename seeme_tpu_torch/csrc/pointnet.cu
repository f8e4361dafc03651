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
// over the four blocks against 2.6 GB per (B, N, 512) f32 activation buffer:
// dense products far above the card's operations-per-byte line, so the tensor
// cores are the limit. The kernel is held to its f32 plain version within
// 1e-4 of max|out|, which one TF32 or bf16 product misses by 3.5x to 26x
// (`ops/split_precision.py`, PERF.md). So every product runs as three bf16 products of split operands,
// a = a_hi + a_lo with a_hi = bf16(a), a_lo = bf16(a - a_hi):
// a_hi b_hi + a_hi b_lo + a_lo b_hi, accumulated in f32 by wgmma (about 5e-6
// of max|out|). That is three times the bf16 operations: the floor of this
// scheme is 3x the tensor-core bound.
//
// The design. One CTA takes TM points of one batch row, 384 threads:
//  - two consumer warpgroups share the (TM, H) output tile, each in one
//    m64n256k16 f32 accumulator (128 registers a thread, setmaxnreg 232):
//    at H = 512 (EgoBody's scene encoder), TM = 64 and each owns 256 of the
//    columns; at H = 256 (the ProHMR-Scene and EgoHMR scene encoders),
//    TM = 128 and each owns 64 of the points across all 256 columns, so the
//    same products serve both widths and every weight slot feeds 128 points
//    (PERF.md has the rejected m64n128k16 design's times). One thread of the
//    producer warpgroup (setmaxnreg 40) feeds the ring;
//  - the weights stream through a ring of STAGES slots in shared memory, one
//    K step (16) of all 2H rows of a product weight a slot, hi rows over lo
//    rows, 32 KB at H = 512 (16 KB at 256) in wgmma's 32-byte swizzle. Each
//    weight is stored slot image by slot image
//    (`ops/pointnet_fused.py::split_weight`: nn.Linear's (out, in) rows,
//    K-major for wgmma's B, cut into K steps, pre-swizzled), so a slot
//    arrives by TMA bulk copies of contiguous bytes (2D TMA boxes of the
//    slot's 32-byte rows were slower, PERF.md). CLUSTER CTAs on
//    neighbouring tiles share every slot: each copies its share and
//    multicasts it to all, so L2 serves each weight byte once per cluster (a
//    CTA alone would read 3 MB, or 5.2 MB in the input block, per 64 points
//    at H = 512);
//  - the A operand of the two products over the block input is built in
//    registers in wgmma's fragment layout: x (f32, from L2, loaded a step
//    ahead) or, in the input block, h recomputed from the tile's three
//    coordinates (three FMAs an element; the (TM, 2H) embedding is never
//    stored), relu where the product takes it, split into hi/lo;
//  - relu(net + bias) goes to shared memory as hi/lo bf16 (2 x 64 KB at
//    either width) in wgmma's swizzled K-major layout and is the A operand,
//    from shared memory, of W_1, accumulated onto the shortcut product;
//  - the epilogue adds the bias, writes out for the tile's valid rows and
//    reduces the column max over them.
// Shared memory at H = 512: 3 x 32 KB ring + 128 KB relu(net) + barriers,
// 230,448 of the 232,448 bytes a CTA may have; the ring cannot be deeper.
// At H = 256: 6 x 16 KB ring + 128 KB relu(net) + barriers, 230,496 bytes.
// The point count need not divide the tile: rows past N load as zero and
// are neither stored nor pooled. The grid is rounded up to whole clusters; a
// CTA past the last tile runs the pipeline for its peers and writes nothing.
// Measured (PERF.md, NVIDIA H100 80GB HBM3 at 700 W), B = 64, N = 20 000: at
// H = 512 22.5 ms and 17.0 ms, 45% and 36% of the split-bf16 floor; each
// warpgroup waits for its products before building the next fragments, and
// the ring's two slots of lead do not hide the weight stream fully. At
// H = 256 5.7 ms and 4.4 ms, 45% and 35% of the floor; there the split
// block's bound is its bytes (2.6 GB of activations in and out), not its
// operations.
// H is a template parameter, instantiated at 512 and 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "refusals.cuh"

namespace {

constexpr int KS = 16;         // K of one ring slot: one bf16 wgmma step
constexpr int CLUSTER = 2;     // CTAs that share every slot through TMA multicast
constexpr int CONSUMERS = 2;   // wgmma warpgroups
constexpr int NT = 128 * (CONSUMERS + 1);

template <int H>
struct Smem {
  static constexpr int WG_COLS = 256;             // wgmma's N
  static constexpr int COL_GROUPS = H / WG_COLS;  // warpgroups side by side over the columns
  static constexpr int ROW_GROUPS = CONSUMERS / COL_GROUPS;  // ... over the points
  static constexpr int TM = 64 * ROW_GROUPS;      // points per CTA
  static constexpr int ACC = WG_COLS / 2;         // f32 accumulators a consumer thread
  static constexpr int STAGES = H == 512 ? 3 : 6;  // ring slots
  static constexpr int HALF = H * KS * 2;         // the hi (or lo) rows of one slot
  static constexpr int SLOT = 2 * HALF;
  static constexpr int NET = TM * H * 2;          // relu(net), hi or lo
  static constexpr int NET_HI = STAGES * SLOT;
  static constexpr int NET_LO = NET_HI + NET;
  static constexpr int BARS = NET_LO + NET;       // full[STAGES], then empty[STAGES]
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;  // + 1024-byte alignment
  static constexpr int SHARE = SLOT / CLUSTER;    // the bytes of a slot each CTA loads
  static_assert(H == 512 || H == 256, "instantiated widths");
  static_assert(COL_GROUPS * ROW_GROUPS == CONSUMERS && (COL_GROUPS == 1 || ROW_GROUPS == 1),
                "the warpgroups split the tile by columns or by points");
  static_assert(SHARE % 16 == 0, "bulk copies move multiples of 16 bytes");
  static_assert(CONSUMERS * 4 * WG_COLS * 4 <= NET_HI, "the epilogue's scratch in the ring");
  static_assert(BYTES <= 232448, "shared memory of one CTA");
};

struct Params {
  const uint8_t* w0;   // the products' split weights (`split_weight`): W_0 (or W_0x),
  const uint8_t* ws;   // W_s (or W_sx) and W_1, in the order the ring streams them
  const uint8_t* w1;
  const float* in;     // x (B, N, H), or the points (B, N, 3)
  const float* wpos;   // input block: W_pos (3, 2H), b_pos (2H)
  const float* bpos;
  const float* bias0;  // b_0 (H), or c0 (B, H)
  const float* bias1;  // b_1 (H), or cs (B, H)
  float* out;          // (B, N, H)
  float* tile_max;     // (B, tiles, H)
  int N, tiles, n_tiles;  // points a row, tiles a row, B * tiles
};

// ---- PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Whether the phase of `bar` with this parity has completed; CLUSTER_SCOPE
// when its arrivals come from other CTAs of the cluster.
template <bool CLUSTER_SCOPE>
__device__ __forceinline__ bool bar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  if constexpr (CLUSTER_SCOPE) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } else {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for that phase. A launch takes tens of milliseconds, so a wait of
// seconds is a stuck pipeline: trap, and the launch fails instead of hanging.
template <bool CLUSTER_SCOPE>
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  if (bar_try<CLUSTER_SCOPE>(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!bar_try<CLUSTER_SCOPE>(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void bar_arrive_remote(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n\t.reg .b32 remote;\n\t"
      "mapa.shared::cluster.u32 remote, %0, %1;\n\t"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n\t}" ::"r"(bar),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\tbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// A TMA bulk copy of `bytes` from device memory into this shared-memory
// offset of every CTA of the cluster, completing bytes on the barrier at
// `bar` in each.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  if constexpr (CLUSTER == 1) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
        : "memory");
  } else {
    const uint16_t mask = (1u << CLUSTER) - 1;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
        " [%0], [%1], %2, [%3], %4;" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask)
        : "memory");
  }
}

// Shared-memory writes of this thread visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma descriptor of a K-major operand in the 32-byte swizzle: rows of 16
// bf16 (32 bytes), 8-row groups 256 bytes apart (SBO = 16 x 16 bytes), LBO
// unused (one K step spans the swizzle width). The operand starts at a
// 256-byte boundary, so the base offset is 0.
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
#define ACC128                                                                                 \
  ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56), ACC8(64),     \
      ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
#define D_REGS                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "    \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "    \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "    \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "    \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "    \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
  "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127}"

// d (+)= A B for a 64 x 16 A in registers (bf16 pairs, wgmma's fragment
// layout) and a 16 x 256 K-major B in shared memory (m64n256k16); d += when
// acc != 0.
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                                         uint32_t acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %132, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " D_REGS
      ", {%128, %129, %130, %131}, %133, p, 1, 1, 0;\n\t}"
      : ACC128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(acc), "l"(b));
}

// The same with A (64 x 16, K-major) in shared memory too.
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t a, uint64_t b, uint32_t acc) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %130, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " D_REGS
      ", %128, %129, p, 1, 1, 0, 0;\n\t}"
      : ACC128
      : "l"(a), "l"(b), "r"(acc));
}

// (x, y) -> their bf16 pair and the bf16 pair of what it leaves out.
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---- A operands built in registers. A thread's fragment of one K step
// (wgmma's m64k16 layout): rows g and g + 8 of its warp's 16, columns
// 2c, 2c + 1 (registers 0, 1) and 2c + 8, 2c + 9 (registers 2, 3) with
// g = lane / 4, c = lane % 4; register q holds row q % 2. `load(step)`
// starts a step's device-memory reads, `fragments<RELU>(step, hi, lo)`
// builds its split fragments.

// x from device memory (L2), loaded a step ahead; a row past N is null and
// reads as zero.
struct XRows {
  const float* row[2];  // this thread's two rows, offset by 2c
  float2 v[4];          // the loaded K step

  __device__ __forceinline__ void load(int step) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* r = row[q & 1];
      v[q] = r ? __ldg(reinterpret_cast<const float2*>(r + KS * step + 8 * (q >> 1)))
               : make_float2(0.f, 0.f);
    }
  }

  template <bool RELU>
  __device__ __forceinline__ void fragments(int, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float x = RELU ? fmaxf(v[q].x, 0.f) : v[q].x;
      const float y = RELU ? fmaxf(v[q].y, 0.f) : v[q].y;
      split2(x, y, hi[q], lo[q]);
    }
  }
};

// The input block's h = pts W_pos + b_pos, recomputed for each K step from
// the two rows' coordinates (zero past N) and W_pos, b_pos (16 KB, L1).
struct HRows {
  float p[2][3];
  const float* wpos;  // (3, K), offset by 2c
  const float* bpos;  // (K), offset by 2c
  int K;

  __device__ __forceinline__ void load(int) {}

  template <bool RELU>
  __device__ __forceinline__ void fragments(int step, uint32_t (&hi)[4], uint32_t (&lo)[4]) const {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = KS * step + 8 * half;
      float2 w[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) w[d] = __ldg(reinterpret_cast<const float2*>(wpos + d * K + k));
      const float2 b = __ldg(reinterpret_cast<const float2*>(bpos + k));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float x = fmaf(p[r][2], w[2].x, fmaf(p[r][1], w[1].x, p[r][0] * w[0].x)) + b.x;
        float y = fmaf(p[r][2], w[2].y, fmaf(p[r][1], w[1].y, p[r][0] * w[0].y)) + b.y;
        if (RELU) {
          x = fmaxf(x, 0.f);
          y = fmaxf(y, 0.f);
        }
        split2(x, y, hi[2 * half + r], lo[2 * half + r]);
      }
    }
  }
};

// A consumer warpgroup's place in the ring.
template <int H>
struct Ring {
  static constexpr int STAGES = Smem<H>::STAGES;
  uint32_t slots, bars;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ __forceinline__ uint32_t empty(int s) const { return bars + 8 * (STAGES + s); }
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  // Slot s is read: thread wt < CLUSTER of the warpgroup tells CTA wt.
  __device__ __forceinline__ void release(int s, int wt) const {
    if (wt < CLUSTER) bar_arrive_remote(empty(s), wt);
  }
};

// acc (+)= A W over `steps` ring slots, A from `src` (relu'd when RELU);
// acc is overwritten when `zero`. Three products a step: hi hi, hi lo, lo hi.
// Each step's products are waited for before the next step's fragments are
// built (building them during the products needs a second fragment set, and
// ptxas then serializes the products for want of registers); the other
// warpgroup's products fill the tensor cores meanwhile. A slot is released
// as soon as its products are done.
template <int H, bool RELU, class Src>
__device__ __forceinline__ void product_regs(float (&acc)[Smem<H>::ACC], Src& src, int steps,
                                             bool zero, Ring<H>& ring, uint32_t b_off, int wt) {
  fence_acc(acc);
  src.load(0);
#pragma unroll 1
  for (int step = 0; step < steps; ++step) {
    uint32_t hi[4], lo[4];
    src.template fragments<RELU>(step, hi, lo);
    if (step + 1 < steps) src.load(step + 1);
    bar_wait<false>(ring.full(ring.stage), ring.phase);
    const uint32_t b = ring.slots + ring.stage * Smem<H>::SLOT + b_off;
    wgmma_fence();
    wgmma_rs(acc, hi, desc_sw32(b), (zero && step == 0) ? 0u : 1u);
    wgmma_rs(acc, hi, desc_sw32(b + Smem<H>::HALF), 1u);
    wgmma_rs(acc, lo, desc_sw32(b), 1u);
    wgmma_commit();
    wgmma_wait<0>();
    ring.release(ring.stage, wt);
    ring.next();
  }
  fence_acc(acc);
}

// acc += relu(net) W_1, relu(net) hi/lo from shared memory; `net_hi` and
// `net_lo` point at this warpgroup's first row.
template <int H>
__device__ __forceinline__ void product_net(float (&acc)[Smem<H>::ACC], uint32_t net_hi,
                                            uint32_t net_lo, Ring<H>& ring, uint32_t b_off,
                                            int wt) {
  constexpr int TM = Smem<H>::TM;
  fence_acc(acc);
#pragma unroll 1
  for (int j = 0; j < H / KS; ++j) {
    bar_wait<false>(ring.full(ring.stage), ring.phase);
    const uint32_t b = ring.slots + ring.stage * Smem<H>::SLOT + b_off;
    const uint64_t a_hi = desc_sw32(net_hi + j * TM * 32), a_lo = desc_sw32(net_lo + j * TM * 32);
    wgmma_fence();
    wgmma_ss(acc, a_hi, desc_sw32(b), 1u);
    wgmma_ss(acc, a_hi, desc_sw32(b + Smem<H>::HALF), 1u);
    wgmma_ss(acc, a_lo, desc_sw32(b), 1u);
    wgmma_commit();
    wgmma_wait<0>();
    ring.release(ring.stage, wt);
    ring.next();
  }
  fence_acc(acc);
}

// relu(acc + bias) as hi/lo bf16 into shared memory, the A operand of W_1:
// K step k16 of it is a (TM, 16) K-major block at k16 * TM * 32 bytes in the
// 32-byte swizzle (16-byte chunk index XOR bit 2 of the row). The warpgroup
// holds rows from `row0` and columns from `col0`.
template <int H>
__device__ __forceinline__ void store_net(const float (&acc)[Smem<H>::ACC], const float* bias,
                                          uint8_t* net_hi, uint8_t* net_lo, int row0, int col0,
                                          int w, int g, int c) {
  constexpr int TM = Smem<H>::TM;
#pragma unroll
  for (int i = 0; i < Smem<H>::WG_COLS / 8; ++i) {
    const int n = col0 + 8 * i + 2 * c;
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + n));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = row0 + 16 * w + g + 8 * r;
      uint32_t hi, lo;
      split2(fmaxf(acc[4 * i + 2 * r] + bv.x, 0.f), fmaxf(acc[4 * i + 2 * r + 1] + bv.y, 0.f), hi,
             lo);
      const int chunk = ((n >> 3) & 1) ^ ((m >> 2) & 1);
      const int off = (n >> 4) * (TM * 32) + m * 32 + chunk * 16 + 4 * c;
      *reinterpret_cast<uint32_t*>(net_hi + off) = hi;
      *reinterpret_cast<uint32_t*>(net_lo + off) = lo;
    }
  }
  fence_async_smem();
}

// out = acc + bias for the tile's valid rows, and the column max over them
// (warp maxima through `scratch`, COLS floats a warp); tile_max null for a
// CTA past the last tile. The warpgroup holds rows from `row0` and columns
// from `col0`; where the two warpgroups split the points (ROW_GROUPS 2),
// the column max takes all eight warps' maxima.
template <int H>
__device__ __forceinline__ void store_out(const float (&acc)[Smem<H>::ACC], const float* bias,
                                          float* out, float* tile_max, int rows, float* scratch,
                                          int wg, int row0, int col0, int w, int g, int c,
                                          int wt) {
  constexpr int COLS = Smem<H>::WG_COLS;
  constexpr int ROW_GROUPS = Smem<H>::ROW_GROUPS;
  const int r0 = row0 + 16 * w + g;
  const bool v0 = r0 < rows, v1 = r0 + 8 < rows;
  float* warp_max = scratch + (wg * 4 + w) * COLS;
#pragma unroll
  for (int i = 0; i < COLS / 8; ++i) {
    const int n = col0 + 8 * i + 2 * c;
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + n));
    const float2 o0 = make_float2(acc[4 * i] + bv.x, acc[4 * i + 1] + bv.y);
    const float2 o1 = make_float2(acc[4 * i + 2] + bv.x, acc[4 * i + 3] + bv.y);
    if (v0) *reinterpret_cast<float2*>(out + (size_t)r0 * H + n) = o0;
    if (v1) *reinterpret_cast<float2*>(out + (size_t)(r0 + 8) * H + n) = o1;
    float mx = fmaxf(v0 ? o0.x : -INFINITY, v1 ? o1.x : -INFINITY);
    float my = fmaxf(v0 ? o0.y : -INFINITY, v1 ? o1.y : -INFINITY);
#pragma unroll
    for (int s = 4; s < 32; s <<= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, s));
      my = fmaxf(my, __shfl_xor_sync(0xffffffffu, my, s));
    }
    if (g == 0) *reinterpret_cast<float2*>(warp_max + 8 * i + 2 * c) = make_float2(mx, my);
  }
  if constexpr (ROW_GROUPS == 1) {
    named_sync(2 + wg, 128);
    if (tile_max) {
      const float* m = scratch + wg * 4 * COLS;
      for (int col = wt; col < COLS; col += 128)
        tile_max[col0 + col] = fmaxf(fmaxf(m[col], m[COLS + col]),
                                     fmaxf(m[2 * COLS + col], m[3 * COLS + col]));
    }
  } else {
    named_sync(1, 128 * CONSUMERS);
    if (tile_max) {
      for (int col = wg * 128 + wt; col < COLS; col += 128 * CONSUMERS) {
        float mx = scratch[col];
#pragma unroll
        for (int j = 1; j < 4 * CONSUMERS; ++j) mx = fmaxf(mx, scratch[j * COLS + col]);
        tile_max[col] = mx;
      }
    }
  }
}

// The producer: every slot of the three products in order (W_0, W_s, W_1),
// this CTA's share of each slot multicast to the cluster. A product weight's
// K step is one contiguous slot image (`split_weight`).
template <int H>
__device__ __forceinline__ void produce(const Params& p, int steps0, uint32_t base, uint32_t bars) {
  using S = Smem<H>;
  const uint32_t share = cluster_rank() * S::SHARE;
  const int total = 2 * steps0 + H / KS;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = 0; it < total; ++it) {
    const uint8_t* w = it < steps0 ? p.w0 : it < 2 * steps0 ? p.ws : p.w1;
    const int step = it < steps0 ? it : it < 2 * steps0 ? it - steps0 : it - 2 * steps0;
    bar_wait<true>(bars + 8 * (S::STAGES + stage), phase ^ 1);
    bar_expect_tx(bars + 8 * stage, S::SLOT);
    bulk_load(base + stage * S::SLOT + share, w + (size_t)step * S::SLOT + share, S::SHARE,
              bars + 8 * stage);
    if (++stage == S::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

template <int H, bool INPUT>
__device__ __forceinline__ void consume(const Params& p, uint8_t* smem, uint32_t base,
                                        uint32_t bars) {
  using S = Smem<H>;
  constexpr int TM = S::TM;
  constexpr int K0 = INPUT ? 2 * H : H;  // depth of the products over the block input
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, w = wt >> 5;
  const int g = (tid & 31) >> 2, c = tid & 3;
  // this warpgroup's part of the tile: 64 rows from wg_row, WG_COLS columns from
  // wg_col; one of the two is 0 at compile time, so that the H = 512 code is
  // that of a kernel with one row group
  const int wg_row = S::ROW_GROUPS == 1 ? 0 : wg * 64;
  const int wg_col = S::COL_GROUPS == 1 ? 0 : wg * S::WG_COLS;
  const int tile = blockIdx.x;
  const bool real = tile < p.n_tiles;
  const int b = real ? tile / p.tiles : 0;
  const int row0 = real ? (tile - b * p.tiles) * TM : 0;
  const int rows = real ? min(TM, p.N - row0) : 0;
  const int r0 = wg_row + 16 * w + g;  // this thread's rows of the tile: r0 and r0 + 8
  Ring<H> ring{base, bars, 0, 0};
  const uint32_t b_off = wg_col * KS * 2;
  float acc[S::ACC] = {};
  if constexpr (INPUT) {
    HRows src;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        src.p[r][d] = r0 + 8 * r < rows ? p.in[((size_t)b * p.N + row0 + r0 + 8 * r) * 3 + d] : 0.f;
    src.wpos = p.wpos + 2 * c;
    src.bpos = p.bpos + 2 * c;
    src.K = K0;
    product_regs<H, true>(acc, src, K0 / KS, true, ring, b_off, wt);
    store_net<H>(acc, p.bias0, smem + S::NET_HI, smem + S::NET_LO, wg_row, wg_col, w, g, c);
    product_regs<H, false>(acc, src, K0 / KS, true, ring, b_off, wt);
  } else {
    XRows src;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      src.row[r] = r0 + 8 * r < rows ? p.in + ((size_t)b * p.N + row0 + r0 + 8 * r) * H + 2 * c
                                     : nullptr;
    product_regs<H, true>(acc, src, K0 / KS, true, ring, b_off, wt);
    store_net<H>(acc, p.bias0 + (size_t)b * H, smem + S::NET_HI, smem + S::NET_LO, wg_row,
                 wg_col, w, g, c);
    product_regs<H, false>(acc, src, K0 / KS, true, ring, b_off, wt);
  }
  named_sync(1, 128 * CONSUMERS);  // relu(net) complete from both warpgroups
  product_net<H>(acc, base + S::NET_HI + wg_row * 32, base + S::NET_LO + wg_row * 32, ring, b_off,
                 wt);
  named_sync(1, 128 * CONSUMERS);  // both done with the ring: its first slots are scratch now
  store_out<H>(acc, p.bias1 + (INPUT ? 0 : (size_t)b * H), p.out + ((size_t)b * p.N + row0) * H,
               real ? p.tile_max + (size_t)tile * H : nullptr, rows, reinterpret_cast<float*>(smem),
               wg, wg_row, wg_col, w, g, c, wt);
}

template <int H, bool INPUT>
__device__ __forceinline__ void block_body(const Params& p) {
  using S = Smem<H>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + S::BARS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      bar_init(bars + 8 * s, 1);                                   // the producer's arrive + bytes
      bar_init(bars + 8 * (S::STAGES + s), CONSUMERS * CLUSTER);  // every consumer of the cluster
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers exist before a multicast or remote arrive
  // One if-else for the whole kernel, so that setmaxnreg holds; each role
  // ends at the cluster barrier, so no CTA leaves while a peer may still
  // arrive on its barriers.
  if (threadIdx.x >= 128 * CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (threadIdx.x == 128 * CONSUMERS) produce<H>(p, (INPUT ? 2 * H : H) / KS, base, bars);
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    consume<H, INPUT>(p, smem, base, bars);
    cluster_sync();
  }
}

template <int H>
__global__ void __launch_bounds__(NT, 1) input_block_kernel(const Params p) {
  block_body<H, true>(p);
}

template <int H>
__global__ void __launch_bounds__(NT, 1) split_block_kernel(const Params p) {
  block_body<H, false>(p);
}

// ---- host side

struct Launch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t config;

  Launch(int n_tiles, size_t smem, void* stream) : config() {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = CLUSTER;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.gridDim = dim3((n_tiles + CLUSTER - 1) / CLUSTER * CLUSTER);
    config.blockDim = dim3(NT);
    config.dynamicSmemBytes = smem;
    config.stream = static_cast<cudaStream_t>(stream);
    config.attrs = attr;
    config.numAttrs = 1;
  }
  Launch(const Launch&) = delete;
};

template <int H, bool INPUT>
cudaError_t run(const Params& p, void* stream) {
  void (*kernel)(const Params) = INPUT ? &input_block_kernel<H> : &split_block_kernel<H>;
  const int smem = Smem<H>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Launch launch(p.n_tiles, smem, stream);
  if ((err = cudaLaunchKernelEx(&launch.config, kernel, p)) != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int H>
Params make_params(const void* w0, const void* ws, const void* w1, const float* in,
                   const float* wpos, const float* bpos, const float* bias0, const float* bias1,
                   float* out, float* tile_max, int B, int N) {
  const int tiles = (N + Smem<H>::TM - 1) / Smem<H>::TM;
  return Params{static_cast<const uint8_t*>(w0), static_cast<const uint8_t*>(ws),
                static_cast<const uint8_t*>(w1), in, wpos, bpos, bias0, bias1, out, tile_max,
                N, tiles, B * tiles};
}

template <int H>
cudaError_t info_of(int input, int* info) {
  using S = Smem<H>;
  void (*kernel)(const Params) = input ? &input_block_kernel<H> : &split_block_kernel<H>;
  const Launch launch(CLUSTER, S::BYTES, nullptr);
  cudaError_t err;
  int fit = 0;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES)) ||
      (err = cudaOccupancyMaxActiveClusters(&fit, kernel, &launch.config)))
    return err;
  const int values[6] = {S::TM, CLUSTER, S::STAGES, S::SLOT, S::BYTES, fit};
  for (int i = 0; i < 6; ++i) info[i] = values[i];
  return cudaSuccess;
}

static_assert(Smem<512>::TM == 64 && Smem<256>::TM == 128, "ops/pointnet_fused.py::TILE");

}  // namespace

// w0, ws: (2H / 16, 2H, 16) and w1: (H / 16, 2H, 16) bf16, each product
// weight's K steps as `ops/pointnet_fused.py::split_weight` lays them out;
// tile_max: (B, ceil(N / TM), H), TM the points a CTA takes at width H
// (`ops/pointnet_fused.py::TILE`).
extern "C" int pointnet_input_block(const float* pts, const float* wpos, const float* bpos,
                                    const void* w0, const float* b0, const void* w1,
                                    const float* b1, const void* ws, float* out,
                                    float* tile_max, int B, int N, int H, void* stream) {
  if (H == 512)
    return run<512, true>(make_params<512>(w0, ws, w1, pts, wpos, bpos, b0, b1, out, tile_max, B,
                                           N), stream);
  if (H == 256)
    return run<256, true>(make_params<256>(w0, ws, w1, pts, wpos, bpos, b0, b1, out, tile_max, B,
                                           N), stream);
  return cudaErrorInvalidValue;
}

// w0x, w1, wsx: (H / 16, 2H, 16) bf16, laid out by `split_weight`.
extern "C" int pointnet_split_block(const float* x, const float* c0, const float* cs,
                                    const void* w0x, const void* w1, const void* wsx,
                                    float* out, float* tile_max, int B, int N, int H,
                                    void* stream) {
  if (H == 512)
    return run<512, false>(make_params<512>(w0x, wsx, w1, x, nullptr, nullptr, c0, cs, out,
                                            tile_max, B, N), stream);
  if (H == 256)
    return run<256, false>(make_params<256>(w0x, wsx, w1, x, nullptr, nullptr, c0, cs, out,
                                            tile_max, B, N), stream);
  return cudaErrorInvalidValue;
}

// The launch at width H: points a CTA, CTAs a cluster, ring slots, bytes a
// slot, dynamic shared memory a CTA, clusters that fit at once.
extern "C" int pointnet_info(int input, int H, int* info) {
  if (H == 512) return info_of<512>(input, info);
  if (H == 256) return info_of<256>(input, info);
  return cudaErrorInvalidValue;
}

// The message of a launcher's error code: a refusal's (refusals.cuh), else CUDA's.
extern "C" const char* seeme_error_string(int err) {
  if (const char* refusal = refusal_string(err)) return refusal;
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
