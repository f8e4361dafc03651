"""Assets -> a ready / not-ready table in one command (`tools/preflight.py`).

    python -m seeme_tpu_torch.tools.preflight [--deps deps] [--datasets datasets]
        [--scan] [--end-to-end] [--out DIR] [--device cpu | --cpu]

Scans `--deps` and `--datasets` for the assets `prepare/README.md`
documents (the SMPL files, `smpl_mean_params.npz`, the CLIP snapshot,
GloVe, the dataset releases, the MLD, ProHMR-Scene and EgoHMR checkpoints,
the TM2T evaluator trio and the action-recognition models), with the JAX
tool's rows, paths and next actions, and loads every asset it finds
through the port's own loaders on the device: `core/smpl.py::load_smpl`
(and the joints of the zero pose), `models/text_encoder.py` for the CLIP
directory, the VAE and denoiser of an MLD Lightning checkpoint with their
widths read from its weights, ProHMR-Scene and EgoHMR (`smpl.*` and, for
EgoHMR, `criterion.*` dropped, as `mld.py:193-208` and `:235-246` load
them), `eval/t2m_evaluator.py`'s three encoders from `finest.tar`, and the
action-recognition GRU and ST-GCN. A loaded asset reads `LOADED`.
`--end-to-end` runs the text-to-motion chain on the port (an MLD
text-to-motion checkpoint sampling through kernel 5, the evaluator trio,
the TM2T and MR metrics) and reads `RAN` with the metric values.

Parity against the genuine reference modules needs `/root/reference`
(`reference_available`). Where it is absent the `reference tree` row reads
`MISSING`, as the JAX tool's does, and each loaded row says that no parity
ran; where it is present the rows say that the port has no reference
parity check. No row prints a parity status. The exit code is 1 when a
row reads `ERROR`, else 0. `--scan` only looks for files and loads
nothing. Nothing is converted (the port loads the torch files as they
are): `--out` is accepted for the JAX tool's command line and unused. It
runs on the card unless `--device cpu` (or `--cpu`) is given, and raises
when there is no card (not with `--scan`).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

REFERENCE = "/root/reference"
READY = ("LOADED", "RAN", "FOUND")


def reference_available() -> bool:
    return os.path.isdir(REFERENCE)


@dataclass
class Row:
    asset: str
    status: str            # MISSING / FOUND / LOADED / RAN / ERROR
    detail: str = ""
    action: str = ""


@dataclass
class Ctx:
    deps: str
    datasets: str
    scan: bool
    device: Optional[torch.device]
    rows: List[Row] = field(default_factory=list)


def _no_parity() -> str:
    return ("; parity not run: /root/reference absent" if not reference_available()
            else "; the port has no reference parity check")


def _load_row(ctx: Ctx, asset: str, load: Callable[[], str]) -> None:
    """Run `load` (it returns the row's detail); an exception becomes an
    ERROR row with its message, so one broken asset does not stop the scan."""
    try:
        ctx.rows.append(Row(asset, "LOADED", load() + _no_parity()))
    except Exception as e:  # noqa: BLE001 — reported in the table, the scan goes on
        ctx.rows.append(Row(asset, "ERROR", f"{type(e).__name__}: {e}"))


def _state_dict(path: str) -> Dict[str, torch.Tensor]:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt)


def _sub(sd: Dict, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _skip_layers(sd: Dict, prefix: str = "encoder.input_blocks.") -> int:
    """A skip stack's num_layers from its keys: 2 * input blocks + 1."""
    ids = {int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix)}
    return 2 * (max(ids) + 1) + 1


def mld_dims(sd: Dict) -> Dict:
    """The widths, layer counts and MD form of an MLD checkpoint's `vae.*`
    and `denoiser.*` weights (`den_*` only when it has a denoiser)."""
    vae_sd, den_sd = _sub(sd, "vae."), _sub(sd, "denoiser.")
    n_tok, d = vae_sd["global_motion_token"].shape
    dims = dict(nfeats=vae_sd["skel_embedding.weight"].shape[1], latent=(n_tok // 2, d),
                vae_ff=vae_sd["encoder.input_blocks.0.linear1.weight"].shape[0],
                vae_layers=_skip_layers(vae_sd))
    if den_sd:
        md_trans = any(".sa_block." in k for k in den_sd)
        dd = den_sd["time_embedding.linear_2.weight"].shape[0]
        dims.update(
            den_md_trans=md_trans, den_layers=_skip_layers(den_sd),
            den_ff=den_sd["encoder.input_blocks.0.ffn.linear1.weight" if md_trans
                          else "encoder.input_blocks.0.linear1.weight"].shape[0],
            den_text=(den_sd["emb_proj.1.weight"].shape[1] if "emb_proj.1.weight" in den_sd
                      else dd))
    return dims


def load_mld(path: str, device) -> str:
    """The checkpoint's VAE (and denoiser) loaded strictly; the VAE's round
    trip of random features must be finite."""
    from ..models.denoiser import Denoiser
    from ..models.vae import MotionVae

    sd = _state_dict(path)
    dims = mld_dims(sd)
    vae = MotionVae(dims["nfeats"], dims["latent"], ff_size=dims["vae_ff"],
                    num_layers=dims["vae_layers"])
    vae.load_state_dict(_sub(sd, "vae."))
    vae = vae.to(device).eval()
    detail = f"vae nfeats={dims['nfeats']} latent={dims['latent']}"
    if "den_layers" in dims:
        den = Denoiser(dims["latent"], ff_size=dims["den_ff"], num_layers=dims["den_layers"],
                       text_encoded_dim=dims["den_text"], md_trans=dims["den_md_trans"])
        den.load_state_dict(_sub(sd, "denoiser."))
        den.to(device)
        detail += (f" + denoiser L={dims['den_layers']} ff={dims['den_ff']} "
                   f"md_trans={dims['den_md_trans']}")
    with torch.no_grad():
        feats = torch.randn(2, 16, dims["nfeats"], device=device)
        rst = vae.decode(vae.encode(feats)[0], 16)
    if not torch.isfinite(rst).all():
        raise ValueError("the VAE's round trip is not finite")
    return detail


def load_hmr(kind: str) -> Callable[[str, torch.device], str]:
    def load(path: str, device) -> str:
        from ..convert import load_reference_checkpoint
        from ..core.smpl import synthetic_smpl

        if kind == "prohmr":
            from ..models.prohmr import ProHMRConfig, ProHMRScene

            model, drop = ProHMRScene(ProHMRConfig(), synthetic_smpl(6890), device=device), \
                ("smpl",)
        else:
            from ..models.egohmr import EgoHmr, EgoHmrConfig

            model, drop = EgoHmr(EgoHmrConfig(), synthetic_smpl(6890), device=device), \
                ("smpl", "criterion")
        unused = load_reference_checkpoint(model, path, drop)
        return f"{os.path.relpath(path)}: {kind} weights, {len(unused)} keys unused"
    return load


def t2m_part(part: str) -> Callable[[str, torch.device], str]:
    """Load one of the evaluator trio's encoders with its widths read from
    its weights."""
    def load(path: str, device) -> str:
        from ..eval.t2m_evaluator import evaluator_state_dicts
        from ..nn.gru import MotionEncoderBiGRUCo, MovementConvEncoder, TextEncoderBiGRUCo

        sd = evaluator_state_dicts(path)[part]
        if part == "text_encoder":
            word, pos = sd["pos_emb.weight"].shape
            m = TextEncoderBiGRUCo(word, pos, sd["input_emb.weight"].shape[0],
                                   sd["output_net.3.weight"].shape[0])
        elif part == "movement_encoder":
            hidden, inp = sd["main.0.weight"].shape[:2]
            m = MovementConvEncoder(inp, hidden, sd["main.3.weight"].shape[0])
        else:
            hidden, inp = sd["input_emb.weight"].shape
            m = MotionEncoderBiGRUCo(inp, hidden, sd["output_net.3.weight"].shape[0])
        m.load_state_dict(sd)
        m.to(device)
        return f"{os.path.relpath(path)}: {part} ({sum(p.numel() for p in m.parameters())} params)"
    return load


def action_model(dataset: str, classes: int) -> Callable[[str, torch.device], str]:
    def load(path: str, device) -> str:
        from ..test.__main__ import action_evaluator

        clf = action_evaluator(dataset, classes, 0, device, path)
        return f"{os.path.relpath(path)}: {type(clf).__name__}, {classes} classes"
    return load


@dataclass
class CkptSpec:
    name: str
    pattern: str
    load: Callable[[str, torch.device], str]
    note: str = ""


def _ckpt_specs(ctx: Ctx) -> List[CkptSpec]:
    d = ctx.deps
    t2m = os.path.join(d, "t2m", "**", "text_mot_match", "**", "finest.tar")
    return [
        CkptSpec("MLD checkpoint (vae+denoiser)", os.path.join(d, "checkpoints_mld", "*.ckpt"),
                 load_mld, "place released epoch=*.ckpt under deps/checkpoints_mld/"),
        CkptSpec("ProHMR-Scene best_model.pt",
                 os.path.join(d, "checkpoints_egohmr", "**", "best_model.pt"), load_hmr("prohmr"),
                 "frozen perception stack (mld.py:185-208)"),
        CkptSpec("EgoHMR best_model_mpjpe_vis.pt",
                 os.path.join(d, "checkpoints_egohmr", "**", "best_model_mpjpe_vis.pt"),
                 load_hmr("egohmr"), "diffusion-GCN branch (mld.py:235-246)"),
        CkptSpec("t2m text encoder (text_mot_match finest.tar)", t2m, t2m_part("text_encoder")),
        CkptSpec("t2m motion encoder", t2m, t2m_part("motion_encoder")),
        CkptSpec("t2m movement encoder", t2m, t2m_part("movement_encoder")),
        CkptSpec("humanact12_gru.tar", os.path.join(d, "actionrecognition", "humanact12_gru.tar"),
                 action_model("humanact12", 12),
                 "point TEST.EVALUATOR_CHECKPOINT at it"),
        CkptSpec("uestc_rot6d_stgcn.tar",
                 os.path.join(d, "actionrecognition", "uestc_rot6d_stgcn.tar"),
                 action_model("uestc", 40)),
    ]


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def check_smpl(ctx: Ctx) -> None:
    base = os.path.join(ctx.deps, "smpl_models", "smpl")
    for gender in ("NEUTRAL", "MALE", "FEMALE"):
        p = os.path.join(base, f"SMPL_{gender}.pkl")
        if not os.path.exists(p):
            ctx.rows.append(Row(f"SMPL_{gender}.pkl", "MISSING", action=f"place at {p}"))
        elif ctx.scan:
            ctx.rows.append(Row(f"SMPL_{gender}.pkl", "FOUND"))
        else:
            _load_row(ctx, f"SMPL_{gender}.pkl", lambda p=p: _load_smpl(p, ctx.device))
    p = os.path.join(ctx.deps, "smpl_mean_params.npz")
    if not os.path.exists(p):
        ctx.rows.append(Row("smpl_mean_params.npz", "MISSING", action=f"place at {p}"))
    elif ctx.scan:
        ctx.rows.append(Row("smpl_mean_params.npz", "FOUND"))
    else:
        keys = set(np.load(p).keys())
        ok = {"shape", "cam"} <= keys or {"pose", "shape"} <= keys
        ctx.rows.append(Row("smpl_mean_params.npz", "FOUND" if ok else "ERROR",
                            f"keys={sorted(keys)}"))


def _load_smpl(path: str, device) -> str:
    from ..core.smpl import load_smpl, smpl_joints24

    m = load_smpl(path, device)
    zeros = lambda n: torch.zeros(1, n, device=device)  # noqa: E731
    j = smpl_joints24(m, zeros(10), zeros(69), zeros(3))
    if not torch.isfinite(j).all():
        raise ValueError("the zero pose's joints are not finite")
    return f"{m.v_template.shape[0]} verts, FK finite"


def check_clip(ctx: Ctx) -> None:
    p = os.path.join(ctx.deps, "clip-vit-large-patch14")
    if not os.path.isdir(p):
        ctx.rows.append(Row("clip-vit-large-patch14", "MISSING", action=f"HF snapshot at {p}"))
        return
    has_cfg = os.path.exists(os.path.join(p, "config.json"))
    weights = glob.glob(os.path.join(p, "*.bin")) + glob.glob(os.path.join(p, "*.safetensors"))
    if not (has_cfg and weights):
        ctx.rows.append(Row("clip-vit-large-patch14", "ERROR",
                            f"config={has_cfg} weights={len(weights)}", "snapshot incomplete"))
    elif ctx.scan:
        ctx.rows.append(Row("clip-vit-large-patch14", "FOUND",
                            f"config={has_cfg} weights={len(weights)}"))
    else:
        def load():
            from ..models.text_encoder import ClipTextEncoder

            enc = ClipTextEncoder(p, device=ctx.device)
            return f"{enc.name} text encoder, {enc(['a person walks']).shape[-1]} wide"
        _load_row(ctx, "clip-vit-large-patch14", load)


def check_glove(ctx: Ctx) -> None:
    p = os.path.join(ctx.deps, "glove")
    found = glob.glob(os.path.join(p, "our_vab_*"))
    ctx.rows.append(Row("GloVe (our_vab_*)", "FOUND" if found else "MISSING",
                        f"{len(found)} files" if found else "",
                        "" if found else f"place our_vab_data/idx/words at {p}"))


def check_datasets(ctx: Ctx) -> None:
    d = ctx.datasets
    prep = "python -m seeme_tpu_torch.tools.preprocess_egobody --root datasets/"
    specs = [
        ("EgoBody", os.path.join(d, "EgoBody", "raw"), prep + "EgoBody"),
        ("GIMO", os.path.join(d, "GIMO", "raw"), prep + "GIMO --pose-dims 63"),
        ("HumanML3D", os.path.join(d, "HumanML3D", "new_joint_vecs"), ""),
        ("KIT-ML", os.path.join(d, "KIT-ML", "new_joint_vecs"), ""),
        ("HumanAct12", os.path.join(d, "HumanAct12", "humanact12poses.pkl"), ""),
        ("UESTC (VIBE cache)", os.path.join(d, "uestc", "vibe_cache"), ""),
    ]
    for name, path, cmd in specs:
        if not os.path.exists(path):
            ctx.rows.append(Row(f"dataset {name}", "MISSING", action=f"place release at {path}"
                                + (f"; then {cmd}" if cmd else "")))
        elif name in ("EgoBody", "GIMO"):
            proc = glob.glob(os.path.join(os.path.dirname(path), "our_process_smpl*", "*.npy"))
            ctx.rows.append(Row(f"dataset {name}", "FOUND", f"{len(proc)} processed shards")
                            if proc else Row(f"dataset {name}", "FOUND", "raw only", f"run: {cmd}"))
        else:
            ctx.rows.append(Row(f"dataset {name}", "FOUND"))


def check_checkpoints(ctx: Ctx) -> None:
    if not reference_available():
        ctx.rows.append(Row("reference tree", "MISSING",
                            "/root/reference absent — parity checks skipped"))
    for spec in _ckpt_specs(ctx):
        hits = sorted(glob.glob(spec.pattern, recursive=True))
        if not hits:
            ctx.rows.append(Row(spec.name, "MISSING", action=f"expected {spec.pattern}"
                                + (f" ({spec.note})" if spec.note else "")))
        elif ctx.scan:
            ctx.rows.append(Row(spec.name, "FOUND", os.path.relpath(hits[0])))
        else:
            _load_row(ctx, spec.name, lambda s=spec, h=hits[0]: s.load(h, ctx.device))


def end_to_end_t2m(mld_path: str, t2m_path: str, device, n: int = 40, T: int = 24,
                   steps: int = 5, guidance: float = 2.5) -> Dict[str, float]:
    """The text-to-motion chain on the port with an MLD checkpoint and the
    evaluator trio: `n` sequences of T frames from seeded motions, text
    embeddings and initial noise (`tools/preflight.py:590-836`'s inputs),
    sampled by `T2MSystem.sample` at `guidance` over `steps` DDIM steps,
    embedded by the trio, scored by `TM2TMetrics` (R_size 8) and
    `MRMetrics`."""
    from ..core.ric import recover_from_ric
    from ..eval.t2m_evaluator import T2MEvaluator, evaluator_state_dicts
    from ..eval.t2m_metrics import MRMetrics, TM2TMetrics
    from ..models.t2m import T2MConfig, T2MSystem

    sd = _state_dict(mld_path)
    dims = mld_dims(sd)
    if dims.get("den_md_trans", True):
        raise ValueError(f"{mld_path} is not a text-to-motion checkpoint (an MD denoiser "
                         "or none)")
    nfeats = dims["nfeats"]
    joints = (nfeats + 1) // 12
    cfg = T2MConfig(nfeats=nfeats, max_len=T, latent_dim=dims["latent"], ff_size=dims["den_ff"],
                    num_layers=dims["den_layers"], text_encoded_dim=dims["den_text"],
                    vae_ff_size=dims["vae_ff"], vae_num_layers=dims["vae_layers"],
                    guidance_scale=guidance, num_inference_timesteps=steps)
    system = T2MSystem(cfg, np.zeros(nfeats, np.float32), np.ones(nfeats, np.float32),
                       device=device)
    system.load_state_dict({**system.state_dict(), **{k: v for k, v in sd.items()
                                                      if k.startswith(("vae.", "denoiser."))}})
    rng = np.random.RandomState(11)
    gt = (0.1 * rng.randn(n, T, nfeats)).astype(np.float32)
    gt[..., :4] += 0.5
    lengths = np.full((n,), T, np.int64)
    text_emb = torch.as_tensor(rng.randn(n, 1, cfg.text_encoded_dim).astype(np.float32),
                               device=device)
    z0 = torch.as_tensor(rng.randn(n, *dims["latent"]).astype(np.float32), device=device)
    captions = [f"a person performs action {i % 7}" for i in range(n)]
    with torch.no_grad():
        feats = system.sample(text_emb, lengths=torch.as_tensor(lengths, device=device),
                              z_init=z0)
    trio = evaluator_state_dicts(t2m_path)
    text_sd, move_sd, mot_sd = (trio[p] for p in ("text_encoder", "movement_encoder",
                                                  "motion_encoder"))
    word, pos = text_sd["pos_emb.weight"].shape
    evaluator = T2MEvaluator(nfeats=nfeats, ckpt=t2m_path, word_size=word, pos_size=pos,
                             text_hidden=text_sd["input_emb.weight"].shape[0],
                             move_hidden=move_sd["main.0.weight"].shape[0],
                             move_out=move_sd["main.3.weight"].shape[0],
                             motion_hidden=mot_sd["input_emb.weight"].shape[0],
                             output_size=text_sd["output_net.3.weight"].shape[0], device=device)
    tm2t = TM2TMetrics(R_size=8, diversity_times=4)
    tm2t.update(evaluator.embed_text(captions), evaluator.embed_motion(feats, lengths),
                evaluator.embed_motion(gt, lengths))
    mr = MRMetrics()
    to_joints = lambda f: recover_from_ric(torch.as_tensor(f, dtype=torch.float64),  # noqa: E731
                                           joints).cpu().numpy()
    mr.update(to_joints(feats.cpu()), to_joints(gt), lengths)
    return {**mr.compute(), **tm2t.compute()}


def check_end_to_end(ctx: Ctx) -> None:
    mld = sorted(glob.glob(os.path.join(ctx.deps, "checkpoints_mld", "*.ckpt")))
    t2m = sorted(glob.glob(os.path.join(ctx.deps, "t2m", "**", "text_mot_match", "**",
                                        "finest.tar"), recursive=True))
    if not mld or not t2m:
        ctx.rows.append(Row("end-to-end t2m metrics", "MISSING",
                            action="needs deps/checkpoints_mld/*.ckpt + "
                                   "deps/t2m/**/text_mot_match/**/finest.tar"))
        return
    try:
        m = end_to_end_t2m(mld[0], t2m[0], ctx.device)
        shown = ", ".join(f"{k}={m[k]:.4f}" for k in ("R_precision_top_1", "Matching_score",
                                                        "FID", "MPJPE") if k in m)
        ctx.rows.append(Row("end-to-end t2m metrics", "RAN", shown + _no_parity()))
    except Exception as e:  # noqa: BLE001 — reported in the table
        ctx.rows.append(Row("end-to-end t2m metrics", "ERROR", f"{type(e).__name__}: {e}"))


def print_table(rows: List[Row]) -> int:
    w_asset = max(len(r.asset) for r in rows) + 2
    w_status = max(len(r.status) for r in rows) + 2
    print(f"{'asset':<{w_asset}}{'status':<{w_status}}detail / next action")
    print("-" * (w_asset + w_status + 40))
    for r in rows:
        extra = r.detail + (f"  [{r.action}]" if r.action else "")
        print(f"{r.asset:<{w_asset}}{r.status:<{w_status}}{extra}")
    n_bad = sum(r.status == "ERROR" for r in rows)
    missing = sum(r.status == "MISSING" for r in rows)
    ok = sum(r.status in READY for r in rows)
    print("-" * (w_asset + w_status + 40))
    print(f"{ok} ready, {missing} missing, {n_bad} failing")
    if missing == 0 and n_bad == 0:
        print("\nall assets ready — quality-parity protocol (BASELINE.md):")
        print("  python -m seeme_tpu_torch.test --cfg configs/config_mld_egobody.yaml "
              "--replication_times 20")
    return 1 if n_bad else 0


def run(argv: Optional[Sequence[str]] = None) -> tuple:
    """(exit code, rows)."""
    ap = argparse.ArgumentParser(prog="python -m seeme_tpu_torch.tools.preflight",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--deps", default="deps")
    ap.add_argument("--datasets", default="datasets")
    ap.add_argument("--out", default=None,
                    help="unused: the port converts nothing (kept for the JAX tool's "
                         "command line)")
    ap.add_argument("--scan", action="store_true", help="presence scan only: no loads")
    ap.add_argument("--end-to-end", action="store_true",
                    help="also run the text-to-motion chain (generation -> evaluator -> "
                         "metric values) on the port")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args = ap.parse_args(argv)
    device = None
    if not args.scan:
        from .._device import full_float32, resolve_device

        device = resolve_device("cpu" if args.cpu else args.device)
        full_float32()
    ctx = Ctx(deps=args.deps, datasets=args.datasets, scan=args.scan, device=device)
    check_smpl(ctx)
    check_clip(ctx)
    check_glove(ctx)
    check_datasets(ctx)
    check_checkpoints(ctx)
    if args.end_to_end and not args.scan:
        check_end_to_end(ctx)
    return print_table(ctx.rows), ctx.rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    return run(argv)[0]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
