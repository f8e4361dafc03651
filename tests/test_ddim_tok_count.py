"""Kernel 5's operation count (`portbench/counts_tok.py`), which the
`ddim_tok_roofline` metric reads, against FlopCounterMode over the
benchmark's plain reference of the token-concat denoiser, on the meta
device: at `humanml3d.test`'s shapes (MLD's published denoiser, 9 layers, 4
heads, ff 1024, text 768, B = 64 under guidance 7.5, 50 steps) and at one
head, 5 layers, ff 128 with 1, 2 and 3 latent and condition tokens."""

import pytest
import torch

from portbench import counts, counts_tok
from portbench.reference import plain
from seeme_tpu_torch.models.denoiser import Denoiser

# heads, ff, layers, text width, batch, guidance, latent tokens, condition tokens
CASES = {"humanml3d.test": (4, 1024, 9, 768, 64, 7.5, 1, 1),
         "one-head": (1, 128, 5, 768, 3, 1.0, 1, 1),
         "tokens": (1, 128, 5, 256, 2, 7.5, 2, 3)}


@pytest.mark.parametrize("case", list(CASES))
def test_ddim_tok_count_matches_flop_counter(case):
    heads, ff, layers, text, batch, guidance, tokens, n_cond = CASES[case]
    den = Denoiser((tokens, 256), ff, layers, heads, text_encoded_dim=text, md_trans=False)
    sd = {f"denoiser.{k}": torch.empty(v.shape, device="meta")
          for k, v in den.state_dict().items()}
    ref = plain.Ref(sd, plain.Arith(), heads=heads)
    rows, steps = batch * (2 if guidance > 1 else 1), 50
    x = torch.empty(rows, tokens, 256, device="meta")
    cond_p = torch.empty(rows, n_cond, 256, device="meta")
    emb = torch.empty(1, 256, device="meta")
    step = counts.counted_flops(lambda: ref.tok_denoise(x, cond_p, emb, layers))
    want = counts_tok.ddim_tok_flops(counts.denoiser_shapes(sd), layers, rows, n_cond, steps,
                                     tokens)
    assert abs(want - steps * step) <= 0.01 * steps * step
    if case == "humanml3d.test":  # about 292 GFLOP a call: 0.3 ms at the bf16 peak
        nbytes = counts.ddim_bytes(counts.denoiser_numels(sd), rows, n_cond, batch, tokens, 256,
                                   steps)
        assert 0.28e-3 < counts.bound_s(want, nbytes) < 0.31e-3
