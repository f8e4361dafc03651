"""JAX param tree -> port state dict, the inverse of
`tools/convert_checkpoint.py::convert_mld_checkpoint` for the sampling path.

`from_jax_params({"vae": ..., "denoiser": ..., "scene_encoder": ...,
"output_scene": ...})`, each a flax `{"params": ...}` tree of numpy arrays,
gives a state dict that `SeeMeSystem.load_state_dict` takes (keys `vae.*`,
`denoiser.*`, `proscene.scene_enc.*`, `output_scene.1.*`); a text-to-motion
tree (`vae`, `denoiser` with plain encoder layers) gives one that
`T2MSystem.load_state_dict` takes. The scene encoder's split halves join
back into one `fc_0` / `shortcut` over [x; pooled].
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Tree = Dict


def _put(sd: Dict, key: str, value) -> None:
    sd[key] = torch.tensor(np.asarray(value, np.float32))


def _linear(sd: Dict, prefix: str, p: Tree) -> None:
    _put(sd, f"{prefix}.weight", np.asarray(p["kernel"]).T)
    if "bias" in p:
        _put(sd, f"{prefix}.bias", p["bias"])


def _norm(sd: Dict, prefix: str, p: Tree) -> None:
    _put(sd, f"{prefix}.weight", p["scale"])
    _put(sd, f"{prefix}.bias", p["bias"])


def _mha(sd: Dict, prefix: str, p: Tree) -> None:
    names = ("q_proj", "k_proj", "v_proj")
    _put(sd, f"{prefix}.in_proj_weight",
         np.concatenate([np.asarray(p[n]["kernel"]).T for n in names]))
    _put(sd, f"{prefix}.in_proj_bias", np.concatenate([np.asarray(p[n]["bias"]) for n in names]))
    _linear(sd, f"{prefix}.out_proj", p["out_proj"])


def _encoder_layer(sd: Dict, prefix: str, p: Tree) -> None:
    _mha(sd, f"{prefix}.self_attn", p["self_attn"])
    for n in ("linear1", "linear2"):
        _linear(sd, f"{prefix}.{n}", p[n])
    for n in ("norm1", "norm2"):
        _norm(sd, f"{prefix}.{n}", p[n])


def _decoder_layer(sd: Dict, prefix: str, p: Tree) -> None:
    _encoder_layer(sd, prefix, p)
    _mha(sd, f"{prefix}.multihead_attn", p["multihead_attn"])
    _norm(sd, f"{prefix}.norm3", p["norm3"])


def _stylization(sd: Dict, prefix: str, p: Tree) -> None:
    _linear(sd, f"{prefix}.emb_layers.1", p["emb_linear"])
    _norm(sd, f"{prefix}.norm", p["norm"])
    _linear(sd, f"{prefix}.out_layers.2", p["out_linear"])


def _md_layer(sd: Dict, prefix: str, p: Tree) -> None:
    _encoder_layer(sd, f"{prefix}.sa_block", p["sa_block"])
    ca = p["ca_block"]
    for n in ("norm", "text_norm"):
        _norm(sd, f"{prefix}.ca_block.{n}", ca[n])
    for n in ("query", "key", "value"):
        _linear(sd, f"{prefix}.ca_block.{n}", ca[n])
    _stylization(sd, f"{prefix}.ca_block.proj_out", ca["proj_out"])
    for n in ("linear1", "linear2"):
        _linear(sd, f"{prefix}.ffn.{n}", p["ffn"][n])
    _stylization(sd, f"{prefix}.ffn.proj_out", p["ffn"]["proj_out"])


def _skip_stack(sd: Dict, prefix: str, p: Tree, layer) -> None:
    for name, sub in p.items():
        if name == "norm":
            _norm(sd, f"{prefix}.norm", sub)
        elif name == "middle":
            layer(sd, f"{prefix}.middle_block", sub)
        elif name.startswith("skip_linear_"):
            _linear(sd, f"{prefix}.linear_blocks.{name.rsplit('_', 1)[1]}", sub)
        else:  # input_i / output_i
            kind, i = name.rsplit("_", 1)
            layer(sd, f"{prefix}.{kind}_blocks.{i}", sub)


def _pe(sd: Dict, key: str, p: Tree) -> None:
    _put(sd, key, np.asarray(p["pe"])[:, None, :])


def vae_state_dict(p: Tree, prefix: str = "vae") -> Dict:
    sd: Dict = {}
    _put(sd, f"{prefix}.global_motion_token", p["global_motion_token"])
    _linear(sd, f"{prefix}.skel_embedding", p["skel_embedding"])
    _linear(sd, f"{prefix}.final_layer", p["final_layer"])
    _pe(sd, f"{prefix}.query_pos_encoder.pe", p["query_pos_encoder"])
    _pe(sd, f"{prefix}.query_pos_decoder.pe", p["query_pos_decoder"])
    _skip_stack(sd, f"{prefix}.encoder", p["encoder"], _encoder_layer)
    _skip_stack(sd, f"{prefix}.decoder", p["decoder"], _decoder_layer)
    return sd


def denoiser_state_dict(p: Tree, prefix: str = "denoiser") -> Dict:
    sd: Dict = {}
    _linear(sd, f"{prefix}.time_embedding.linear_1", p["time_embedding"]["linear_1"])
    _linear(sd, f"{prefix}.time_embedding.linear_2", p["time_embedding"]["linear_2"])
    _pe(sd, f"{prefix}.query_pos.pe", p["query_pos"])
    md_trans = "sa_block" in p["encoder"]["middle"]
    _skip_stack(sd, f"{prefix}.encoder", p["encoder"], _md_layer if md_trans else _encoder_layer)
    if "emb_proj_dense" in p:
        _linear(sd, f"{prefix}.emb_proj.1", p["emb_proj_dense"])
    return sd


def pointnet_state_dict(p: Tree, prefix: str = "proscene.scene_enc") -> Dict:
    sd: Dict = {}
    _linear(sd, f"{prefix}.fc_pos_0", p["fc_pos_0"])
    _linear(sd, f"{prefix}.fc_c", p["fc_c"])
    b0 = p["block_0"]
    for n in ("fc_0", "fc_1", "shortcut"):
        _linear(sd, f"{prefix}.block_0.{n}", b0[n])
    for i in (1, 2, 3):
        b = p[f"block_{i}"]
        _linear(sd, f"{prefix}.block_{i}.fc_0",
                {"kernel": np.concatenate([b["fc_0_x"]["kernel"], b["fc_0_p"]["kernel"]]),
                 "bias": b["fc_0_x"]["bias"]})
        _linear(sd, f"{prefix}.block_{i}.fc_1", b["fc_1"])
        _linear(sd, f"{prefix}.block_{i}.shortcut",
                {"kernel": np.concatenate([b["shortcut_x"]["kernel"],
                                           b["shortcut_p"]["kernel"]])})
    return sd


def from_jax_params(tree: Tree) -> Dict[str, torch.Tensor]:
    """{'vae', 'denoiser', 'scene_encoder', 'output_scene'} flax trees (any
    subset) -> one port state dict."""
    sd: Dict = {}
    if "vae" in tree:
        sd.update(vae_state_dict(tree["vae"]["params"]))
    if "denoiser" in tree:
        sd.update(denoiser_state_dict(tree["denoiser"]["params"]))
    if "scene_encoder" in tree:
        sd.update(pointnet_state_dict(tree["scene_encoder"]["params"]))
    if "output_scene" in tree:
        _linear(sd, "output_scene.1", tree["output_scene"]["params"]["linear"])
    return sd
