// Kernel 3's T = 1 instance (ddim_md.cuh, TF = 1) in a translation unit of
// its own, so that nvcc compiles it beside the general one (ddim_md.cu),
// whose entries call these two.

#include "ddim_md.cuh"

extern "C" int ddim_md_launch_t1(const float* z0, float* z_out, const float* inv_cond,
                                 const float* inv_step, const void* wptr, const float* acp_t,
                                 const float* acp_prev, const float* pe, int B, int Bc, int NC,
                                 int F1, int FF, int L, int steps, float guidance, int cfg,
                                 void* stream) {
  return launch<1>(z0, z_out, inv_cond, inv_step, wptr, acp_t, acp_prev, pe, B, Bc, NC, F1, FF,
                   L, steps, 1, guidance, cfg, stream);
}

extern "C" int ddim_md_describe_t1(int B, int NC, int F1, int FF, int L, int cfg, int* info) {
  return describe<1>(B, 1, NC, F1, FF, L, cfg, info);
}
