"""The port's preflight (`python -m seeme_tpu_torch.tools.preflight`)
against the root `tools/preflight.py`, on the CPU.

`--scan` on an empty tree gives the root tool's asset rows, in its order,
with the same MISSING statuses and exit code 0. A tree written here (an
SMPL `.pkl` by `core/smpl.py::save_smpl`, a Lightning-style checkpoint of a
small text-to-motion system, the TM2T evaluator trio in `finest.tar`, the
HumanAct12 GRU) is read as ready: each of those rows LOADED, the
`--end-to-end` chain RAN with finite metrics, no ERROR, exit code 0; no row
carries a parity status. A broken checkpoint is an ERROR row and exit code
1, and `--scan` loads nothing.
"""

import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seeme_tpu_torch.core.smpl import save_smpl, synthetic_smpl
from seeme_tpu_torch.eval.action_classifier import MotionDiscriminator
from seeme_tpu_torch.models.t2m import T2MConfig, T2MSystem
from seeme_tpu_torch.nn.gru import MotionEncoderBiGRUCo, MovementConvEncoder, TextEncoderBiGRUCo
from seeme_tpu_torch.nn.init import init_parameters_
from seeme_tpu_torch.tools import preflight
from test_torch_a2m import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent


def root_preflight():
    spec = importlib.util.spec_from_file_location("root_preflight", ROOT / "tools" / "preflight.py")
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def rows_of(out):
    """(asset, status) of each table line between the two rules."""
    lines = out.splitlines()
    rules = [i for i, line in enumerate(lines) if line.startswith("-----")]
    body = lines[rules[0] + 1:rules[1]]
    statuses = {"MISSING", "FOUND", "LOADED", "RAN", "ERROR", "PARITY-OK", "PARITY-FAIL",
                "CONVERTED"}
    rows = []
    for line in body:
        words = line.split()
        k = next(i for i, w in enumerate(words) if w in statuses)
        rows.append((" ".join(words[:k]), words[k]))
    return rows


def test_scan_of_an_empty_tree_matches_the_root_tool(tmp_path, capsys):
    argv = ["--scan", "--deps", str(tmp_path / "deps"), "--datasets", str(tmp_path / "data")]
    assert root_preflight().main(argv) == 0
    ref = rows_of(capsys.readouterr().out)
    rc, rows = preflight.run(argv)
    ours = rows_of(capsys.readouterr().out)
    assert rc == 0 and ours == ref == [(r.asset, r.status) for r in rows]
    assert {s for _, s in ours} == {"MISSING"} and len(ours) == 21


def write_tree(deps):
    torch.manual_seed(0)
    smpl = deps / "smpl_models" / "smpl"
    smpl.mkdir(parents=True)
    save_smpl(synthetic_smpl(256), str(smpl / "SMPL_NEUTRAL.pkl"))
    cfg = T2MConfig(latent_dim=(1, 32), ff_size=16, num_layers=3, text_encoded_dim=48,
                    max_len=24)
    system = T2MSystem(cfg, np.zeros(263, np.float32), np.ones(263, np.float32), device="cpu",
                       seed=0)
    (deps / "checkpoints_mld").mkdir()
    torch.save({"state_dict": system.state_dict(), "epoch": 9},
               deps / "checkpoints_mld" / "epoch=9.ckpt")
    trio = {"text_encoder": TextEncoderBiGRUCo(300, 15, 24, 16),
            "movement_encoder": MovementConvEncoder(259, 24, 16),
            "motion_encoder": MotionEncoderBiGRUCo(16, 24, 16)}
    for m in trio.values():
        init_parameters_(m, torch.Generator().manual_seed(1))
    t2m = deps / "t2m" / "t2m" / "text_mot_match" / "model"
    t2m.mkdir(parents=True)
    torch.save({k: m.state_dict() for k, m in trio.items()}, t2m / "finest.tar")
    (deps / "actionrecognition").mkdir()
    gru = MotionDiscriminator(output_size=12)
    init_parameters_(gru, torch.Generator().manual_seed(2))
    torch.save({"state_dict": gru.state_dict()}, deps / "actionrecognition" / "humanact12_gru.tar")


def test_a_written_tree_is_ready(tmp_path, capsys):
    deps = tmp_path / "deps"
    write_tree(deps)
    argv = ["--deps", str(deps), "--datasets", str(tmp_path / "data"), "--cpu", "--end-to-end"]
    rc, rows = preflight.run(argv)
    status = {r.asset: r for r in rows}
    loaded = ["SMPL_NEUTRAL.pkl", "MLD checkpoint (vae+denoiser)",
              "t2m text encoder (text_mot_match finest.tar)", "t2m motion encoder",
              "t2m movement encoder", "humanact12_gru.tar"]
    assert [status[a].status for a in loaded] == ["LOADED"] * 6, [status[a] for a in loaded]
    assert "denoiser L=3 ff=16 md_trans=False" in status["MLD checkpoint (vae+denoiser)"].detail
    e2e = status["end-to-end t2m metrics"]
    assert e2e.status == "RAN", e2e
    for name in ("R_precision_top_1", "Matching_score", "FID", "MPJPE"):
        value = float(e2e.detail.split(f"{name}=")[1].split(",")[0].split(";")[0])
        assert math.isfinite(value), (name, e2e.detail)
    assert rc == 0 and not any(r.status == "ERROR" for r in rows)
    assert all("PARITY" not in r.status for r in rows)
    assert all("parity not run" in status[a].detail for a in loaded)
    assert "0 failing" in capsys.readouterr().out

    (deps / "checkpoints_egohmr").mkdir()
    torch.save({"state_dict": {"smpl.x": torch.zeros(1)}},
               deps / "checkpoints_egohmr" / "best_model.pt")
    rc, rows = preflight.run(argv[:-1])
    bad = {r.asset: r for r in rows}["ProHMR-Scene best_model.pt"]
    assert rc == 1 and bad.status == "ERROR" and "missing" in bad.detail
    rc, rows = preflight.run(["--scan", *argv[:4]])
    assert rc == 0 and {r.status for r in rows} <= {"MISSING", "FOUND"}


def test_missing_card_is_refused_unless_scanning(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        preflight.main(["--deps", str(tmp_path)])
    assert preflight.main(["--scan", "--deps", str(tmp_path)]) == 0
