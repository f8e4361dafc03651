"""Component registry: a YAML `target:` -> the port's class
(`seeme_tpu/config/registry.py`).

The reference instantiates modules from dotted import strings; the JAX
package and the port resolve targets through an allow-list instead, the JAX
package's native names (`seeme_tpu.Denoiser`) and the reference's dotted
ones (`mld.models.architectures.mld_denoiser.MldDenoiser`) alike, each to
the port's counterpart. An unknown target raises with the registered ones.
`instantiate_from_config` passes the node's `params` that the constructor
takes; the module YAMLs carry the reference modules' extra keyword
arguments (`normalize_before`, `activation`, ...), which the reference's
constructors swallow through `**kwargs` and which the JAX registry drops
too; `instantiate_from_config` returns them beside the instance rather
than hiding them.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Tuple

_COMPONENTS: Dict[str, Callable] = {}


def register_component(*names: str):
    def deco(fn):
        for n in names:
            _COMPONENTS[n] = fn
        return fn

    return deco


def _populate() -> None:
    if _COMPONENTS:
        return
    from ..diffusion.schedulers import DiffusionSchedule
    from ..models.denoiser import Denoiser
    from ..models.text_encoder import ClipTextEncoder
    from ..models.vae import MotionVae
    from ..nn.gru import MotionEncoderBiGRUCo, MovementConvEncoder, TextEncoderBiGRUCo
    from ..nn.pointnet import ResnetPointnet
    from ..nn.resnet import resnet50

    _COMPONENTS.update({
        "seeme_tpu.MotionVae": MotionVae,
        "mld.models.architectures.mld_vae.MldVae": MotionVae,
        "seeme_tpu.Denoiser": Denoiser,
        "mld.models.architectures.mld_denoiser.MldDenoiser": Denoiser,
        "seeme_tpu.DiffusionSchedule": DiffusionSchedule,
        "diffusers.DDIMScheduler": DiffusionSchedule,
        "diffusers.DDPMScheduler": DiffusionSchedule,
        "seeme_tpu.ClipTextEncoder": ClipTextEncoder,
        "mld.models.architectures.mld_clip.MldTextEncoder": ClipTextEncoder,
        "seeme_tpu.ResnetPointnet": ResnetPointnet,
        "seeme_tpu.resnet50": resnet50,
        "mld.models.architectures.t2m_textenc.TextEncoderBiGRUCo": TextEncoderBiGRUCo,
        "mld.models.architectures.t2m_textenc.MovementConvEncoder": MovementConvEncoder,
        "mld.models.architectures.t2m_motionenc.MotionEncoder": MotionEncoderBiGRUCo,
    })


def get_component(target: str) -> Callable:
    _populate()
    if target not in _COMPONENTS:
        raise KeyError(f"unknown component target {target!r}; registered: "
                       f"{sorted(_COMPONENTS)}")
    return _COMPONENTS[target]


def instantiate_from_config(node: Dict, **overrides: Any) -> Tuple[Any, Dict[str, Any]]:
    """{'target': ..., 'params': {...}} -> (an instance of the registered
    class built from the params its constructor names, the params it does
    not take)."""
    ctor = get_component(str(node["target"]))
    params = dict(node.get("params") or {})
    params.update(overrides)
    names = inspect.signature(ctor).parameters
    if any(p.kind is inspect.Parameter.VAR_KEYWORD for p in names.values()):
        return ctor(**params), {}
    taken = {k: v for k, v in params.items() if k in names}
    return ctor(**taken), {k: v for k, v in params.items() if k not in names}
