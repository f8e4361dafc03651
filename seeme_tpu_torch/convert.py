"""JAX param tree -> port state dict, the inverse of
`tools/convert_checkpoint.py::convert_mld_checkpoint` for the sampling path.

`from_jax_params({"vae": ..., "denoiser": ..., "scene_encoder": ...,
"output_scene": ..., "image_encoder": ..., "output_images": ...})`, each a
flax `{"params": ...}` tree of numpy arrays (the image encoder's with its
`batch_stats`), gives a state dict that `SeeMeSystem.load_state_dict` takes
(keys `vae.*`, `denoiser.*`, `proscene.scene_enc.*`, `output_scene.1.*`,
`image_encoder.*` in torchvision's layout, `output_images.1.*`); a
text-to-motion tree (`vae`, `denoiser` with plain encoder layers) gives one
that `T2MSystem.load_state_dict` takes. The scene encoder's split halves
join back into one `fc_0` / `shortcut` over [x; pooled]; the VAE's
`dist_layer` (MLP_DIST) and an all-encoder decoder map as they are; the
ResNet's conv kernels go from HWIO to OIHW and its batch statistics to
`running_mean` / `running_var`.

`prohmr_state_dict` and `egohmr_state_dict` do the same for the perception
stack's `init_params` trees (`seeme_tpu/models/{prohmr,egohmr}.py`), the
inverses of `convert_checkpoint.py`'s ProHMR branch and `convert_egohmr`,
batch statistics included (the port trains them as parameters under the
same keys); `discriminator_state_dict` maps the ProHMR discriminator, which
the converter does not read back.
A text-to-motion denoiser of either arch (`trans_enc`'s U-skip encoder,
`trans_dec`'s decoder stack and `mem_pos`) and the diffusion-only
`pose_embd` / `pose_proj` map too, so `from_jax_params` takes a whole
`T2MSystem.init_params` tree; `t2m_{text,movement,motion}_state_dict` map
the TM2T evaluator's three flax trees (`seeme_tpu/nn/gru.py`) onto
`nn/gru.py`'s reference keys. An action-to-motion tree's `embed_action`
maps to `embed_action.action_embedding`, so `from_jax_params` takes a whole
`A2MSystem.init_params` tree; `action_gru_state_dict` and
`stgcn_state_dict` map the two action-recognition evaluators
(`seeme_tpu/eval/{action_classifier,stgcn}.py`), the inverses of
`convert_a2m_gru` and `convert_uestc_stgcn`.
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
    if "dist_layer" in p:
        _linear(sd, f"{prefix}.dist_layer", p["dist_layer"])
    _pe(sd, f"{prefix}.query_pos_encoder.pe", p["query_pos_encoder"])
    _pe(sd, f"{prefix}.query_pos_decoder.pe", p["query_pos_decoder"])
    _skip_stack(sd, f"{prefix}.encoder", p["encoder"], _encoder_layer)
    cross = "multihead_attn" in p["decoder"]["middle"]  # encoder_decoder, not all_encoder
    _skip_stack(sd, f"{prefix}.decoder", p["decoder"], _decoder_layer if cross else _encoder_layer)
    return sd


def denoiser_state_dict(p: Tree, prefix: str = "denoiser") -> Dict:
    """Either arch: the U-skip `encoder` (MD or plain layers) or the plain
    `decoder` stack with `mem_pos`; the diffusion-only `pose_embd` /
    `pose_proj` when present."""
    sd: Dict = {}
    _linear(sd, f"{prefix}.time_embedding.linear_1", p["time_embedding"]["linear_1"])
    _linear(sd, f"{prefix}.time_embedding.linear_2", p["time_embedding"]["linear_2"])
    _pe(sd, f"{prefix}.query_pos.pe", p["query_pos"])
    if "decoder" in p:  # arch="trans_dec"
        _pe(sd, f"{prefix}.mem_pos.pe", p["mem_pos"])
        _norm(sd, f"{prefix}.decoder.norm", p["decoder"]["norm"])
        for name, sub in p["decoder"].items():
            if name.startswith("layer_"):
                _decoder_layer(sd, f"{prefix}.decoder.layers.{name.split('_')[1]}", sub)
    else:
        md_trans = "sa_block" in p["encoder"]["middle"]
        _skip_stack(sd, f"{prefix}.encoder", p["encoder"],
                    _md_layer if md_trans else _encoder_layer)
    for name, key in (("emb_proj_dense", "emb_proj.1"), ("pose_embd", "pose_embd"),
                      ("pose_proj", "pose_proj")):
        if name in p:
            _linear(sd, f"{prefix}.{key}", p[name])
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


def resnet_state_dict(tree: Tree, prefix: str = "image_encoder") -> Dict:
    """flax ResNet50 `{"params", "batch_stats"}` (`seeme_tpu/nn/resnet.py`)
    -> torchvision keys, the inverse of `convert_resnet50`."""
    params, stats = tree["params"], tree["batch_stats"]
    sd: Dict = {}

    def conv(name: str, p: Tree) -> None:
        _put(sd, f"{prefix}.{name}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))

    def bn(name: str, p: Tree, s: Tree) -> None:
        _norm(sd, f"{prefix}.{name}", p)
        _put(sd, f"{prefix}.{name}.running_mean", s["mean"])
        _put(sd, f"{prefix}.{name}.running_var", s["var"])

    conv("conv1", params["conv1"])
    bn("bn1", params["bn1"], stats["bn1"])
    for name, p in params.items():
        if not name.startswith("layer"):
            continue
        t = name.replace("_", ".")  # layer{s}_{b} -> layer{s}.{b}
        for c in (1, 2, 3):
            conv(f"{t}.conv{c}", p[f"conv{c}"])
            bn(f"{t}.bn{c}", p[f"bn{c}"], stats[name][f"bn{c}"])
        if "downsample_conv" in p:
            conv(f"{t}.downsample.0", p["downsample_conv"])
            bn(f"{t}.downsample.1", p["downsample_bn"], stats[name]["downsample_bn"])
    return sd


def glow_state_dict(tree: Tree, prefix: str = "flow.flow") -> Dict:
    """`seeme_tpu/flows/glow.py` params {"layers": [...]} -> the nflows keys
    of `flows/glow.py::ConditionalGlow` (slots 3i, 3i + 1, 3i + 2), with
    or without the blocks' batch norm, the inverse of `convert_glow`."""
    sd: Dict = {}

    def wb(key: str, p: Tree) -> None:
        _put(sd, f"{key}.weight", p["w"])
        _put(sd, f"{key}.bias", p["b"])

    for i, layer in enumerate(tree["layers"]):
        t = f"{prefix}._transform._transforms"
        for name in ("log_scale", "shift"):
            _put(sd, f"{t}.{3 * i}.{name}", layer["actnorm"][name])
        for name in ("lower_entries", "upper_entries", "unconstrained_upper_diag", "bias"):
            _put(sd, f"{t}.{3 * i + 1}.{name}", layer["lu"][name])
        net, p = f"{t}.{3 * i + 2}.transform_net", layer["coupling"]["resnet"]
        wb(f"{net}.initial_layer", p["initial"])
        wb(f"{net}.final_layer", p["final"])
        for j, block in enumerate(p["blocks"]):
            for k in (0, 1):
                wb(f"{net}.blocks.{j}.linear_layers.{k}", block[f"linear{k}"])
                if f"bn{k}" not in block:  # use_batch_norm=False
                    continue
                bn, key = block[f"bn{k}"], f"{net}.blocks.{j}.batch_norm_layers.{k}"
                _norm(sd, key, bn)
                _put(sd, f"{key}.running_mean", bn["mean"])
                _put(sd, f"{key}.running_var", bn["var"])
    return sd


def gcn_state_dict(tree: Tree, prefix: str = "diffusion_model") -> Dict:
    """flax `ModulatedGCN` {"params", "batch_stats"} (`seeme_tpu/nn/gcn.py`)
    -> `nn/gcn.py` keys, the inverse of `convert_egohmr`'s GCN part."""
    params, stats = tree["params"], tree["batch_stats"]
    sd: Dict = {}

    def gconv(key: str, p: Tree) -> None:
        for name in ("W", "M", "adj2", "bias"):
            _put(sd, f"{key}.{name}", p[name])

    def block(key: str, p: Tree, s: Tree) -> None:
        gconv(f"{key}.gconv", p["gconv"])
        _norm(sd, f"{key}.bn", p["bn"])
        _put(sd, f"{key}.bn.running_mean", s["bn"]["mean"])
        _put(sd, f"{key}.bn.running_var", s["bn"]["var"])

    block(f"{prefix}.gconv_input.0", params["gconv_input"], stats["gconv_input"])
    layers = sorted(int(k.split("_")[1]) for k in params if k.startswith("res_"))
    for i in layers:
        for j in (1, 2):
            block(f"{prefix}.gconv_layers.{i}.gconv{j}", params[f"res_{i}"][f"gconv{j}"],
                  stats[f"res_{i}"][f"gconv{j}"])
    gconv(f"{prefix}.gconv_output", params["gconv_output"])
    return sd


def _mlp(sd: Dict, prefix: str, p: Tree, names=("fc1", "fc2")) -> None:
    """Two flax Dense layers -> elements 0 and 2 of a Linear-act-Linear."""
    _linear(sd, f"{prefix}.0", p[names[0]])
    _linear(sd, f"{prefix}.2", p[names[1]])


def discriminator_state_dict(tree: Tree, prefix: str = "discriminator") -> Dict:
    """flax `Discriminator` {"params"} (`seeme_tpu/models/prohmr.py:109`) ->
    the reference's keys (`models/prohmr.py::Discriminator`): the per-joint
    Dense layers as 1x1 convolutions, the (23, 32, 1) head as 23 Linear(32,
    1), and the all-joints input rows from joint-major (j * 32 + c) to the
    reference's channel-major order (c * 23 + j)."""
    p, sd = tree["params"], {}
    for name in ("D_conv1", "D_conv2"):
        _put(sd, f"{prefix}.{name}.weight", np.asarray(p[name]["kernel"]).T[:, :, None, None])
        _put(sd, f"{prefix}.{name}.bias", p[name]["bias"])
    w, b = np.asarray(p["pose_out_w"]), np.asarray(p["pose_out_b"])
    for j in range(w.shape[0]):
        _put(sd, f"{prefix}.pose_out.{j}.weight", w[j, :, 0][None])
        _put(sd, f"{prefix}.pose_out.{j}.bias", b[j])
    for name in ("betas_fc1", "betas_fc2", "betas_out", "D_alljoints_fc2", "D_alljoints_out"):
        _linear(sd, f"{prefix}.{name}", p[name])
    fc1 = p["D_alljoints_fc1"]
    k = np.asarray(fc1["kernel"])
    joints = w.shape[0]
    k = k.reshape(joints, -1, k.shape[-1]).transpose(1, 0, 2).reshape(k.shape)
    _linear(sd, f"{prefix}.D_alljoints_fc1", {"kernel": k, "bias": fc1["bias"]})
    return sd


def prohmr_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """`ProHMRScene.init_params` tree (`seeme_tpu/models/prohmr.py`) -> the
    state dict of `models/prohmr.py::ProHMRScene`, the discriminator's part
    too when the tree has one."""
    sd: Dict = {}
    sd.update(resnet_state_dict(tree["backbone"], "backbone"))
    sd.update(pointnet_state_dict(tree["scene_enc"]["params"], "scene_enc"))
    sd.update(glow_state_dict(tree["flow"], "flow.flow"))
    _mlp(sd, "flow.fc_head.layers", tree["fc_head"]["params"])
    if "discriminator" in tree:
        sd.update(discriminator_state_dict(tree["discriminator"]))
    return sd


def egohmr_state_dict(tree: Tree) -> Dict[str, torch.Tensor]:
    """`EgoHmr.init_params` tree (`seeme_tpu/models/egohmr.py`) -> the state
    dict of `models/egohmr.py::EgoHmr`."""
    sd: Dict = {}
    sd.update(resnet_state_dict(tree["backbone"], "backbone"))
    sd.update(pointnet_state_dict(tree["scene_enc"]["params"], "scene_enc"))
    _mlp(sd, "transl_enc.layers", tree["transl_enc"]["params"])
    _mlp(sd, "embed_timestep.time_embed", tree["timestep_embedder"]["params"],
         ("linear_1", "linear_2"))
    _linear(sd, "input_process.poseEmbedding", tree["input_process"]["params"])
    sd.update(gcn_state_dict(tree["gcn"]))
    _mlp(sd, "beta_layer.layers", tree["beta_layer"]["params"])
    return sd


def from_jax_params(tree: Tree) -> Dict[str, torch.Tensor]:
    """{'vae', 'denoiser', 'scene_encoder', 'output_scene', 'image_encoder',
    'output_images'} flax trees (any subset) -> one port state dict."""
    sd: Dict = {}
    if "vae" in tree:
        sd.update(vae_state_dict(tree["vae"]["params"]))
    if "denoiser" in tree:
        sd.update(denoiser_state_dict(tree["denoiser"]["params"]))
    if "scene_encoder" in tree:
        sd.update(pointnet_state_dict(tree["scene_encoder"]["params"]))
    if "image_encoder" in tree:
        sd.update(resnet_state_dict(tree["image_encoder"]))
    for name in ("output_scene", "output_images"):
        if name in tree:
            _linear(sd, f"{name}.1", tree[name]["params"]["linear"])
    if "embed_action" in tree:
        _put(sd, "embed_action.action_embedding",
             tree["embed_action"]["params"]["action_embedding"])
    return sd


def action_gru_state_dict(tree: Tree) -> Dict:
    """flax `MotionDiscriminator` -> `eval/action_classifier.py` keys: cell k
    of the scanned stack is layer k of `recurrent` (`nn.GRU`)."""
    p, sd = tree["params"], {}
    for name, cell in p["recurrent"].items():
        k = name.rsplit("_", 1)[1]
        for gate in ("ih", "hh"):
            dense = cell[f"weight_{gate}"]
            _put(sd, f"recurrent.weight_{gate}_l{k}", np.asarray(dense["kernel"]).T)
            _put(sd, f"recurrent.bias_{gate}_l{k}", dense["bias"])
    for name in ("linear1", "linear2"):
        _linear(sd, name, p[name])
    return sd


def _bn(sd: Dict, prefix: str, p: Tree) -> None:
    for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                         ("running_var", "var")):
        _put(sd, f"{prefix}.{ours}", p[theirs])


def _conv2d(sd: Dict, prefix: str, p: Tree) -> None:
    """flax (kH, kW, in, out) -> torch (out, in, kH, kW)."""
    _put(sd, f"{prefix}.weight", np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    _put(sd, f"{prefix}.bias", p["bias"])


def stgcn_state_dict(tree: Tree) -> Dict:
    """flax `STGCN` -> `eval/stgcn.py` keys; the dense classifier as the
    reference's 1x1 convolution `fcn`."""
    p, sd = tree["params"], {}
    _bn(sd, "data_bn", p["data_bn"])
    i = 0
    while f"block_{i}" in p:
        b, prefix = p[f"block_{i}"], f"st_gcn_networks.{i}"
        _conv2d(sd, f"{prefix}.gcn.conv", b["gcn"]["conv"])
        _bn(sd, f"{prefix}.tcn.0", b["bn1"])
        _conv2d(sd, f"{prefix}.tcn.2", b["tcn"])
        _bn(sd, f"{prefix}.tcn.3", b["bn2"])
        if "res_conv" in b:
            _conv2d(sd, f"{prefix}.residual.0", b["res_conv"])
            _bn(sd, f"{prefix}.residual.1", b["res_bn"])
        _put(sd, f"edge_importance.{i}", p[f"edge_importance_{i}"])
        i += 1
    _put(sd, "fcn.weight", np.asarray(p["fcn"]["kernel"]).T[:, :, None, None])
    _put(sd, "fcn.bias", p["fcn"]["bias"])
    return sd


def _bigru(sd: Dict, prefix: str, p: Tree) -> None:
    """`nn/gru.py::BiGru` (torch's `nn.GRU` keys) from the flax `fwd` / `bwd`
    cells, the inverse of `convert_checkpoint.py::convert_bigru`."""
    for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
        cell = p[direction]["cell"]
        for gate in ("ih", "hh"):
            _put(sd, f"{prefix}.weight_{gate}_l0{suffix}",
                 np.asarray(cell[f"weight_{gate}"]["kernel"]).T)
            _put(sd, f"{prefix}.bias_{gate}_l0{suffix}", cell[f"weight_{gate}"]["bias"])


def _gru_encoder(sd: Dict, p: Tree) -> None:
    _linear(sd, "input_emb", p["input_emb"])
    _put(sd, "hidden", p["hidden"])
    _bigru(sd, "gru", p["gru"])
    _linear(sd, "output_net.0", p["out_0"])
    _norm(sd, "output_net.1", p["out_ln"])
    _linear(sd, "output_net.3", p["out_1"])


def t2m_text_state_dict(tree: Tree) -> Dict:
    """flax `TextEncoderBiGRUCo` {"params"} -> `nn/gru.py` keys, the inverse
    of `convert_t2m_textencoder`."""
    sd: Dict = {}
    _linear(sd, "pos_emb", tree["params"]["pos_emb"])
    _gru_encoder(sd, tree["params"])
    return sd


def t2m_motion_state_dict(tree: Tree) -> Dict:
    """flax `MotionEncoderBiGRUCo` -> `nn/gru.py` keys (`convert_t2m_motionencoder`)."""
    sd: Dict = {}
    _gru_encoder(sd, tree["params"])
    return sd


def t2m_movement_state_dict(tree: Tree) -> Dict:
    """flax `MovementConvEncoder` -> `nn/gru.py` keys: the (k, in, out)
    convolution kernels as (out, in, k) (`convert_t2m_movementencoder`)."""
    p, sd = tree["params"], {}
    for name, key in (("conv1", "main.0"), ("conv2", "main.3")):
        _put(sd, f"{key}.weight", np.asarray(p[name]["kernel"]).transpose(2, 1, 0))
        _put(sd, f"{key}.bias", p[name]["bias"])
    _linear(sd, "out_net", p["out_net"])
    return sd


def load_reference_checkpoint(module: torch.nn.Module, path: str, drop=("smpl",)) -> list:
    """Load a torch checkpoint with the reference's key names (its
    `state_dict` entry, or the file itself) into `module`, without the keys
    under the `drop` prefixes (`smpl.*`, as `convert_checkpoint.py` filters
    them). Every key the module holds must be there; returns the keys the
    module has no place for (buffers such as `num_batches_tracked`, modules
    of training)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items() if not k.startswith(tuple(drop))}
    result = module.load_state_dict(sd, strict=False)
    if result.missing_keys:
        raise KeyError(f"{path}: missing {len(result.missing_keys)} keys, e.g. "
                       f"{result.missing_keys[:5]}")
    return list(result.unexpected_keys)
