"""A run with the timed path broken underneath comes out not correct, once
for each fault the cells can have (one card: no exchange between chips):
the reverse process returning its state unchanged, half the batch computed
and the rest filled from it, and one sequence's answer altered where it is
made. The look for a card is skipped: the runs are on the CPU, at a small
size."""

import pytest
import torch

from portbench import harness
from seeme_tpu_torch.models import seeme, t2m

from .small import SEED, shrink

# each cell's reverse process as its configuration runs it: kernel 3 for
# SEE-ME; the loop over the denoiser for MLD's four-head model, which the
# token kernel (one head) does not take
FAMILIES = {"egobody.test.fresh": (seeme, "ddim_fused", seeme.SeeMeSystem, "sample_from_cond"),
            "humanml3d.test": (t2m, "ddim_sample", t2m.T2MSystem, "sample")}


def unchanged(module, name, cls, method, mp):
    # the initial noise back: ddim_fused's third argument, ddim_sample's z_init
    mp.setattr(module, name, lambda *a, **k: k["z_init"] if "z_init" in k else a[2])


def half_batch(module, name, cls, method, mp):
    real = getattr(cls, method)

    def halved(self, first, *args, **kwargs):
        h = first.shape[0] // 2
        cut = {k: (v[:h] if torch.is_tensor(v) and v.shape[:1] == first.shape[:1] else v)
               for k, v in kwargs.items()}
        out = real(self, first[:h], *args, **cut)
        return torch.cat([out, out])[: first.shape[0]]

    mp.setattr(cls, method, halved)


def altered(module, name, cls, method, mp):
    real = getattr(module, name)

    def one_changed(*args, **kwargs):
        z = real(*args, **kwargs).clone()
        z[0] = z[-1]
        return z

    mp.setattr(module, name, one_changed)


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(FAMILIES))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    shrink(monkeypatch)
    fault(*FAMILIES[cell], monkeypatch)
    r = harness.run_cell(cell, SEED, 0.05, False, "cpu")
    assert not r["correct"], r["compared"]
