"""Kernels 3 and 5 at one latent token, timed on the card, so that two trees
of the port can be compared in one call.

    python seeme_tpu_torch/ops/ddim_t1_timing.py [--root DIR] [--general] [--reps 5]

Imports `seeme_tpu_torch` from DIR (default: the tree that holds this file),
builds its kernels, and times through its wrappers, with CUDA events, on
seeded random weights at B = 64 and 50 steps: `ddim_fused` on the EgoBody
denoiser's widths (two condition tokens of width 256) at guidance 1.0 and
2.5, and `ddim_fused_tok` at the text-to-motion shape (text 768) at guidance
7.5 and 1.0 and at the shipped preset's (text 256, guidance 1.0). Each case
is the mean of `--reps` launches after one warm-up. `--general` also times
kernel 3's general instance (`ddim_md_kernel<0>`, T read at run time) at T
= 1, from a copy of `csrc/ddim_md.cu` whose entry sends T = 1 to that
instance, built with the other sources into its own library. Prints one
JSON line. Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

# ddim_md.cu's dispatch to the T = 1 instance, and what replaces it
_T1_DISPATCH = ("  if (T == 1) return ddim_md_launch_t1(", "  if (false) return ddim_md_launch_t1(")


def build_general(build, tmp: Path):
    """The kernel library with kernel 3's T = 1 calls sent to the general
    instance."""
    text = (build.CSRC / "ddim_md.cu").read_text()
    if text.count(_T1_DISPATCH[0]) != 1:
        raise RuntimeError(f"ddim_t1_timing: ddim_md.cu no longer has one {_T1_DISPATCH[0]!r}")
    (tmp / "ddim_md.cu").write_text(text.replace(*_T1_DISPATCH))
    for hdr in build.CSRC.glob("*.cuh"):
        (tmp / hdr.name).write_text(hdr.read_text())
    (tmp / "ddim_md_t1.cu").write_text((build.CSRC / "ddim_md_t1.cu").read_text())
    sources = [tmp / s.name if s.name.startswith("ddim_md") else s for s in build._sources()]
    nvcc = build.find_nvcc()
    objs = [tmp / f"{s.stem}.o" for s in sources]
    procs = [subprocess.Popen([nvcc, *build.NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate(timeout=build.BUILD_TIMEOUT)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    lib = tmp / "libddim_general_t1.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)], check=True,
                   capture_output=True, timeout=build.BUILD_TIMEOUT)
    return build.open_library(lib)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--general", action="store_true")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from seeme_tpu_torch.diffusion.schedulers import DiffusionSchedule
    from seeme_tpu_torch.models.denoiser import Denoiser
    from seeme_tpu_torch.nn.init import init_parameters_, perturb_parameters_
    from seeme_tpu_torch.ops import _build
    from seeme_tpu_torch.ops import denoiser_fused as dfu

    if not torch.cuda.is_available():
        raise SystemExit("ddim_t1_timing: needs a CUDA card")
    dev = torch.device("cuda")
    B, steps = 64, 50

    def seeded(module, seed):
        init_parameters_(module, torch.Generator().manual_seed(seed))
        perturb_parameters_(module, torch.Generator().manual_seed(seed + 100))
        return module.requires_grad_(False).eval().to(dev).state_dict()

    def time_ms(run):
        run()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    md = seeded(Denoiser((1, 256), ff_size=128, num_layers=5), 3)
    toks = {w: seeded(Denoiser((1, 256), ff_size=128, num_layers=5, text_encoded_dim=w,
                               md_trans=False), 6) for w in (768, 256)}
    weights = {"md": dfu.KernelWeights(md, 5),
               **{w: dfu.KernelWeights(sd, 5, md_trans=False) for w, sd in toks.items()}}
    sched = DiffusionSchedule()
    cases = [("md", 1.0, 2, 256), ("md", 2.5, 2, 256), ("tok", 7.5, 1, 768),
             ("tok", 1.0, 1, 768), ("tok", 1.0, 1, 256)]

    def run_case(kind, g, n_cond, width):
        gen = torch.Generator().manual_seed(4)
        z0 = torch.randn(B, 1, 256, generator=gen).to(dev)
        cond = torch.randn((2 if g > 1 else 1) * B, n_cond, width, generator=gen).to(dev)
        if kind == "md":
            return lambda: dfu.ddim_fused(md, cond, z0, sched, steps, 5, g, weights=weights["md"])
        return lambda: dfu.ddim_fused_tok(toks[width], cond, z0, sched, steps, 5, g,
                                          weights=weights[width])

    _build.load_library()
    out = {"root": args.root, "device": torch.cuda.get_device_name(0), "batch": B,
           "steps": steps, "reps": args.reps, "ms": {}}
    for case in cases:
        out["ms"][f"{case[0]} text {case[3]} guidance {case[1]}"] = time_ms(run_case(*case))
    if args.general:
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            own = _build.load_library()
            _build._lib = build_general(_build, Path(tmp))  # the wrappers launch this copy
            try:
                for case in cases[:2]:
                    out["ms"][f"md general instance guidance {case[1]}"] = time_ms(
                        run_case(*case))
            finally:
                _build._lib = own
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
