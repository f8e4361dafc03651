// The launchers' own refusals: codes past every cudaError_t, returned where
// a shape is within the kernels' widths but past a limit of their design.
// `seeme_error_string` (pointnet.cu) gives each one's message, which names
// the limit; `ops/_build.py::check` raises it as a ValueError.

#pragma once

#define DDIM_TOK_MAX_ROWS 30  // token rows a cluster of kernel 5 holds
#define GCN_CHANNELS 64       // channels a CTA of csrc/gcn.cu takes
#define SEEME_STR2(x) #x
#define SEEME_STR(x) SEEME_STR2(x)

enum Refusal : int {
  REFUSE_TOKEN_ROWS = 10001,   // kernel 5: one sample's token rows past DDIM_TOK_MAX_ROWS
  REFUSE_SAMPLE_SMEM = 10002,  // a DDIM kernel: one sample past a CTA's shared memory
  REFUSE_TOK_HEADS = 10003,    // kernel 5: a head width that is not whole warps
  REFUSE_GCN_WIDTH = 10004,    // the GCN kernels: a width that is not whole CTA tiles
};

// The message of a refusal, or nullptr for any other code.
inline const char* refusal_string(int err) {
  switch (err) {
    case REFUSE_TOKEN_ROWS:
      return "kernel 5 takes at most " SEEME_STR(DDIM_TOK_MAX_ROWS) " token rows a sample "
             "(T + 1 + NC, twice that under CFG; MAX_ROWS in csrc/ddim_tok.cu)";
    case REFUSE_SAMPLE_SMEM:
      return "one sample's rows need more shared memory a CTA than the card allows "
             "(cudaDevAttrMaxSharedMemoryPerBlockOptin)";
    case REFUSE_TOK_HEADS:
      return "kernel 5 takes heads whose width (256 / num_heads) is a whole number of "
             "32-column warp passes: 1, 2, 4 or 8 heads";
    case REFUSE_GCN_WIDTH:
      return "the GCN kernels take hidden widths that are a multiple of " SEEME_STR(GCN_CHANNELS)
             " (the channels of one CTA, csrc/gcn.cu)";
    default:
      return nullptr;
  }
}
