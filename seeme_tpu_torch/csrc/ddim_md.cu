// Kernel 3 (ddim_md.cuh): the library's entries, and the general instance
// (TF = 0, T read at run time); T = 1 goes to the specialisation, built
// apart in ddim_md_t1.cu.

#include "ddim_md.cuh"

extern "C" int ddim_md_launch_t1(const float* z0, float* z_out, const float* inv_cond,
                                 const float* inv_step, const void* wptr, const float* acp_t,
                                 const float* acp_prev, const float* pe, int B, int Bc, int NC,
                                 int F1, int FF, int L, int steps, float guidance, int cfg,
                                 void* stream);
extern "C" int ddim_md_describe_t1(int B, int NC, int F1, int FF, int L, int cfg, int* info);

// z0, z_out (B, T, D); inv_cond (L, Bc, NC, 4, D); inv_step (L, steps, 6, D);
// wptr: device array of (L * 32 + 2 * ((L - 1) / 2) + 3) weight pointers;
// acp_t, acp_prev (steps,); pe (T, D), query_pos rows 0..T-1 (T = 1 reads row
// 0 from wptr). cfg != 0: Bc = 2B rows [uncond; cond]. D = 256. T = 1 runs the
// T = 1 specialisation, T > 1 the general instance; REFUSE_SAMPLE_SMEM when
// one sample's rows do not fit a CTA's shared memory.
extern "C" int ddim_md(const float* z0, float* z_out, const float* inv_cond,
                       const float* inv_step, const void* wptr, const float* acp_t,
                       const float* acp_prev, const float* pe, int B, int Bc, int NC, int D_,
                       int F1, int FF, int L, int steps, int T, float guidance, int cfg,
                       void* stream) {
  if (!takes(NC, D_, F1, FF, L, B, T) || steps < 1) return cudaErrorInvalidValue;
  if (T == 1) return ddim_md_launch_t1(z0, z_out, inv_cond, inv_step, wptr, acp_t, acp_prev, pe,
                                       B, Bc, NC, F1, FF, L, steps, guidance, cfg, stream);
  return launch<0>(z0, z_out, inv_cond, inv_step, wptr, acp_t, acp_prev, pe, B, Bc, NC, F1, FF, L,
                   steps, T, guidance, cfg, stream);
}

// The launch `ddim_md` makes for these arguments, without launching:
// info[5] = CTAs per cluster, CTAs in the grid, clusters that fit at once,
// dynamic shared memory bytes per CTA, samples a cluster.
extern "C" int ddim_md_info(int B, int T, int NC, int D_, int F1, int FF, int L, int cfg,
                            int* info) {
  if (!takes(NC, D_, F1, FF, L, B, T)) return cudaErrorInvalidValue;
  if (T == 1) return ddim_md_describe_t1(B, NC, F1, FF, L, cfg, info);
  return describe<0>(B, T, NC, F1, FF, L, cfg, info);
}
