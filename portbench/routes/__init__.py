"""The window's work: what one batch of the closed loop runs through the
port, what the benchmark keeps of it for the comparison, and the plain
reference of the same batch. Each route is a module of this package, found
by the name a traffic mix gives under `route` (`registry.route`), whose
`ROUTE` is a subclass of `Route`:

* `ego_fresh.py`: the EgoBody test CLI's `--count_time` batch;
* `t2m_text.py`: text-to-motion sampling, joints and a per-batch metric.

The latents are read where the program decodes them: `vae.decode` is
wrapped to note its input, nothing else.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

from portbench import counts
from portbench.reference import plain
from portbench.systems import Built
from portbench.traffic import Traffic


class Spans:
    """The benchmark's spans around each layer call: in a traced run a
    profiler range `bench.<name>` and CUDA events (the host clock on the
    CPU, where the harness's tests run); otherwise nothing."""

    def __init__(self, on: bool, cuda: bool = True):
        self.on, self.cuda = on, cuda
        self.events: Dict[str, List] = {}

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        with torch.profiler.record_function(f"bench.{name}"):
            start = self._mark()
            yield
            end = self._mark()
        self.events.setdefault(name, []).append((start, end))

    def ms(self) -> Dict[str, List[float]]:
        """Each span's milliseconds (after a synchronise)."""
        if not self.cuda:
            return {k: [1e3 * (b - a) for a, b in v] for k, v in self.events.items()}
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}


def _meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    return x


def relative_gap(pairs, masks=None) -> float:
    """max |program - reference| / max |reference| over every pair (and the
    valid rows of `masks`)."""
    num = den = 0.0
    for i, (p, r) in enumerate(pairs):
        p, r = p.float(), r.float()
        if masks is not None:
            m = masks[i]
            p, r = p[m], r[m]
        num = max(num, float((p - r).abs().max()))
        den = max(den, float(r.abs().max()))
    return num / den if den > 0 else float("inf")


class Route:
    compared = ()

    def __init__(self, built: Built, traffic: Traffic, conf: Dict, ref_module):
        self.built, self.traffic, self.conf, self.refm = built, traffic, conf, ref_module
        self.system = built.system
        self.model = conf["config"]["model"]
        self.batch = traffic.batch_size
        self._latent = None
        decode = self.system.vae.decode

        def noted(z, *args, **kwargs):
            self._latent = z
            return decode(z, *args, **kwargs)

        self.system.vae.decode = noted

    def release(self) -> None:
        """Drop the program's state once the window has closed."""
        self.system = None
        self.built.system = None

    def finite_rows(self, out) -> torch.Tensor:
        j = out["joints"]
        return torch.isfinite(j.reshape(j.shape[0], -1)).all(1)

    def masks(self, inp) -> Optional[Dict[str, torch.Tensor]]:
        return None

    def shapes(self) -> Dict:
        """The cell's shapes that the kernels' counts read."""
        m = self.model
        return {"batch": self.batch, "steps": int(m["scheduler"]["num_inference_timesteps"]),
                "cond_rows": self.batch * (2 if m["guidance_scale"] > 1.0 else 1),
                "tokens": int(m["latent_dim"][0]), "width": int(m["latent_dim"][-1]),
                "layers": int(m["num_layers"]),
                "denoiser_shapes": counts.denoiser_shapes(self.built.weights),
                "denoiser_numels": counts.denoiser_numels(self.built.weights)}

    def batch_flops(self) -> float:
        """Operations of one window batch, counted by FlopCounterMode over
        the reference on the meta device (shapes only)."""
        inp = _meta(self.prepare(-1))
        saved = self.built
        self.built = Built(None, _meta(saved.weights), _meta(saved.body), _meta(saved.mean),
                           _meta(saved.std))
        try:
            return float(counts.counted_flops(lambda: self.reference(plain.Arith(), inp)))
        finally:
            self.built = saved
