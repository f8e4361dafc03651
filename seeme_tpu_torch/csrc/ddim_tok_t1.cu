// Kernel 5's T = 1 instance (ddim_tok.cuh, TF = 1) in a translation unit of
// its own, so that nvcc compiles it beside the general one (ddim_tok.cu),
// whose entries call these two.

#include "ddim_tok.cuh"

extern "C" int ddim_tok_launch_t1(const float* z0, float* z_out, const float* cond_in,
                                  const float* time_in, const void* wptr, const float* acp_t,
                                  const float* acp_prev, const float* pe, int B, int NC, int FF,
                                  int L, int NH, int steps, float guidance, int cfg, void* stream) {
  return launch<1>(z0, z_out, cond_in, time_in, wptr, acp_t, acp_prev, pe, B, NC, FF, L, NH,
                   steps, 1, guidance, cfg, stream);
}

extern "C" int ddim_tok_describe_t1(int B, int NC, int FF, int L, int NH, int cfg, int* info) {
  return describe<1>(B, 1, NC, FF, L, NH, cfg, info);
}
