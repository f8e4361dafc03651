// Kernel 5 (ddim_tok.cuh): the library's entries, and the general instance
// (TF = 0, T read at run time); T = 1 goes to the specialisation, built
// apart in ddim_tok_t1.cu.

#include "ddim_tok.cuh"

extern "C" int ddim_tok_launch_t1(const float* z0, float* z_out, const float* cond_in,
                                  const float* time_in, const void* wptr, const float* acp_t,
                                  const float* acp_prev, const float* pe, int B, int NC, int FF,
                                  int L, int NH, int steps, float guidance, int cfg, void* stream);
extern "C" int ddim_tok_describe_t1(int B, int NC, int FF, int L, int NH, int cfg, int* info);

// z0, z_out (B, T, D); cond_in (Bc, NC, D), the projected condition tokens
// plus their positional rows T+1..T+NC, Bc = 2B rows [uncond; cond] when cfg
// != 0; time_in (steps, D), every step's time token plus positional row T;
// wptr: device array of (L * 16 + 2 * ((L - 1) / 2) + 3) weight pointers;
// acp_t, acp_prev (steps,); pe (T, D), query_pos rows 0..T-1 (T = 1 reads row
// 0 from wptr). D = 256, 1 <= NC <= 8, NH heads. T = 1 runs the T = 1
// specialisation, T > 1 the general instance; REFUSE_TOK_HEADS past
// whole-warp heads, REFUSE_TOKEN_ROWS past MAX_ROWS token rows a sample,
// REFUSE_SAMPLE_SMEM past a CTA's shared memory.
extern "C" int ddim_tok(const float* z0, float* z_out, const float* cond_in,
                        const float* time_in, const void* wptr, const float* acp_t,
                        const float* acp_prev, const float* pe, int B, int NC, int FF, int L,
                        int NH, int steps, int T, float guidance, int cfg, void* stream) {
  if (const int err = refusal(NH)) return err;
  if (!takes(NC, FF, L, B, T) || steps < 1) return cudaErrorInvalidValue;
  if (T == 1) return ddim_tok_launch_t1(z0, z_out, cond_in, time_in, wptr, acp_t, acp_prev, pe, B,
                                        NC, FF, L, NH, steps, guidance, cfg, stream);
  return launch<0>(z0, z_out, cond_in, time_in, wptr, acp_t, acp_prev, pe, B, NC, FF, L, NH,
                   steps, T, guidance, cfg, stream);
}

// The launch `ddim_tok` makes for these arguments, without launching:
// info[5] = CTAs per cluster, CTAs in the grid, clusters that fit at once,
// dynamic shared memory bytes per CTA, samples a cluster.
extern "C" int ddim_tok_info(int B, int T, int NC, int FF, int L, int NH, int cfg, int* info) {
  if (const int err = refusal(NH)) return err;
  if (!takes(NC, FF, L, B, T)) return cudaErrorInvalidValue;
  if (T == 1) return ddim_tok_describe_t1(B, NC, FF, L, NH, cfg, info);
  return describe<0>(B, T, NC, FF, L, NH, cfg, info);
}
