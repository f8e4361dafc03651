"""Text-to-motion batches: caption embeddings at the denoiser's text width,
one fixed set of lengths from the mix's shortest to its longest clip in an
order drawn from the seed (every batch and every seed do the same work),
and reference motion features zero past each length. The mix gives
`lengths` (`min`, `max`), `text` (`scale`) and `motion` (`scale`)."""

from __future__ import annotations

from typing import Dict

import torch

from portbench.systems import generator


def lengths(mix: Dict, B: int) -> torch.Tensor:
    """The mix's one set of B lengths, shortest and longest included."""
    lo, hi = mix["lengths"]["min"], mix["lengths"]["max"]
    return torch.tensor([lo + round((hi - lo) * k / max(1, B - 1)) for k in range(B)],
                        dtype=torch.int64)


def batch(traffic, i: int) -> Dict[str, torch.Tensor]:
    """text_emb (B, width), length (B,), motion (B, max_len, nfeats) zero
    past each length."""
    conf, mix, dev = traffic.conf, traffic.mix, traffic.device
    c = conf["config"]
    g = generator(traffic.seed, "batch", dev, i)
    B, T = traffic.batch_size, int(c["DATASET"]["SAMPLER"]["MAX_LEN"])
    width = int(c["model"]["denoiser"]["params"]["text_encoded_dim"])
    order = torch.randperm(B, generator=g, device=dev)
    length = lengths(mix, B).to(dev)[order]
    valid = torch.arange(T, device=dev)[None] < length[:, None]
    motion = torch.randn(B, T, conf["nfeats"], generator=g, device=dev)
    text = torch.randn(B, width, generator=g, device=dev) * mix["text"]["scale"]
    return {"text_emb": text, "length": length,
            "motion": motion * mix["motion"]["scale"] * valid[..., None]}
