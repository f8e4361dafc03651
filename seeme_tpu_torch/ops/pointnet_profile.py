"""The PointNet kernels' time under variants of their design.

    python -m seeme_tpu_torch.ops.pointnet_profile [--variants cluster1,cluster2,cluster4,nowait]
        [--hidden 512|256] [--points 20000] [--batch 64]

Copies `csrc/pointnet.cu` into a temporary directory under
`seeme_tpu_torch/_build/`, patches one design choice per variant, builds
each copy (with the DDIM sources) into its own library, and runs both
kernels through their wrappers on a seeded `ResnetPointnet(512, hidden)`
(512: the EgoBody scene encoder; 256: the ProHMR-Scene and EgoHMR ones)
at B x N points: the variants in turn, then in reverse order. Variants:
`clusterK` shares each weight slot across K CTAs (the source's own is 2;
1 is no multicast); `nowait` is a timing-only build in which the producer
copies nothing and the products do not wait for their slots, so its
results are meaningless and its time is the kernels' without the weight
stream; `source` is the source as it is. One JSON line per variant and
kernel: ms (CUDA events, mean of 3 launches after a warm-up) and, except for
`nowait`, the larger error of out and the pool relative to max |out| of the
plain version. Needs nvcc and a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from pathlib import Path

from . import _build

_CLUSTER = "constexpr int CLUSTER = 2;"
# (anchor, replacement, times the anchor occurs)
_NOWAIT = (
    ("    bar_wait<false>(ring.full(ring.stage), ring.phase);\n", "", 2),  # both products
    ("  const int total = 2 * steps0 + H / KS;", "  const int total = 0;", 1),
)


def _patch(text: str, edits) -> str:
    for anchor, new, times in edits:
        if text.count(anchor) != times:
            raise RuntimeError(f"pointnet_profile: the source no longer has {times} {anchor!r}")
        text = text.replace(anchor, new)
    return text


def variant_source(name: str) -> str:
    text = (_build.CSRC / "pointnet.cu").read_text()
    if name == "source":
        return text
    if name.startswith("cluster"):
        return _patch(text, ((_CLUSTER, f"constexpr int CLUSTER = {int(name[7:])};", 1),))
    if name == "nowait":
        return _patch(text, _NOWAIT)
    raise ValueError(f"pointnet_profile: unknown variant {name!r}")


def build(tmp: Path, names) -> dict:
    """One library per variant; the DDIM objects are compiled once."""
    nvcc = _build.find_nvcc()
    jobs = [(_build.CSRC / "ddim_md.cu", tmp / "ddim_md.o"),
            (_build.CSRC / "ddim_tok.cu", tmp / "ddim_tok.o")]
    for name in names:
        (tmp / f"pointnet_{name}.cu").write_text(variant_source(name))
        jobs.append((tmp / f"pointnet_{name}.cu", tmp / f"pointnet_{name}.o"))
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-c", "-o",
                               str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in jobs]
    logs = [p.communicate(timeout=_build.BUILD_TIMEOUT)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    libs = {}
    for name in names:
        lib = tmp / f"libpointnet_{name}.so"
        subprocess.run([nvcc, "-shared", "-o", str(lib), str(tmp / f"pointnet_{name}.o"),
                        str(tmp / "ddim_md.o"), str(tmp / "ddim_tok.o")], check=True,
                       capture_output=True, timeout=_build.BUILD_TIMEOUT)
        libs[name] = _build.open_library(lib)
    return libs


def main() -> None:
    import torch

    from ..nn.init import init_parameters_, perturb_parameters_
    from ..nn.pointnet import ResnetPointnet
    from . import pointnet_fused as pfu

    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="cluster1,cluster2,cluster4,nowait")
    ap.add_argument("--hidden", type=int, default=512, choices=(256, 512))
    ap.add_argument("--points", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=64)
    args = ap.parse_args()
    names = args.variants.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("pointnet_profile: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    net = ResnetPointnet(512, args.hidden)
    init_parameters_(net, torch.Generator().manual_seed(1))
    perturb_parameters_(net, torch.Generator().manual_seed(101))
    w = pfu.pointnet_weights(net.requires_grad_(False).to(dev))
    pts = torch.randn(args.batch, args.points, 3, generator=torch.Generator().manual_seed(2))
    pts = pts.to(dev)
    in_args = (pts, *(w[n] for n in ("wpos", "bpos", "w0", "b0", "w1", "b1", "ws")))
    in_split = tuple(w[f"{n}.split"] for n in pfu.INPUT_SPLIT)
    x, pooled = pfu.fused_input_block_plain(*in_args)
    sp_args = (x, pooled, *(w[f"block_1.{n}"]
                            for n in ("w0x", "w0p", "b0", "w1", "b1", "wsx", "wsp")))
    sp_split = tuple(w[f"block_1.{n}.split"] for n in pfu.BLOCK_SPLIT)
    plain = {"input": (x, pooled), "split": pfu.fused_split_block_plain(*sp_args)}
    runs = {"input": lambda: pfu.fused_input_block(*in_args, split=in_split),
            "split": lambda: pfu.fused_split_block(*sp_args, split=sp_split)}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(Path(tmp), names)
        for name in names + names[::-1] if len(names) > 1 else names:
            _build._lib = libs[name]  # the wrappers launch this variant's kernels
            for kernel, run in runs.items():
                got = run()
                torch.cuda.synchronize()
                ref, ref_pool = plain[kernel]
                err = None if name == "nowait" else float(
                    max((got[0] - ref).abs().max(), (got[1] - ref_pool).abs().max())
                    / ref.abs().max())
                del got
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(3):
                    run()
                end.record()
                torch.cuda.synchronize()
                print(json.dumps({"variant": name, "kernel": kernel, "hidden": args.hidden,
                                  "batch": args.batch,
                                  "points": args.points, "ms": start.elapsed_time(end) / 3,
                                  "relative_error": err}), flush=True)
        _build._lib = None


if __name__ == "__main__":
    main()
