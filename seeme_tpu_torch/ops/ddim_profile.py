"""Where the two DDIM kernels' time goes, from an instrumented build.

    python -m seeme_tpu_torch.ops.ddim_profile [--batch 64,1] [--steps 50]
        [--threads 256:512,512:512]

Copies the DDIM kernel sources (`csrc/ddim_*`, `csrc/refusals.cuh`) into a
temporary directory under `seeme_tpu_torch/_build/`, adds `clock64()`
counters that CTA 0's thread 0 sums over a launch of the T = 1 instances,
builds the copy (with `pointnet.cu`) into its own library, and runs both
kernels through their wrappers on seeded random weights: the MD kernel at guidance 1 and 2.5 on
the EgoBody denoiser's widths, the token kernel at 1 and 7.5 on the
text-to-motion denoiser's, 50 steps. `--threads` builds one such library
per pair of CTA sizes (MD kernel : token kernel, as `DDIM_THREADS`; the
sources' own are 256:512) and runs them in turn, then in reverse order.
For each case it prints one JSON line: the launch's ms (CUDA events; the
counters cost a few percent), its cycles, and the share of them in each
phase of the cluster products and in the row-wise work between them. Needs
nvcc and a card.

Phases of a product group (`ddim_common.cuh::cluster_dense`): `arrive` the
relaxed arrive that frees the outputs; per product, `weights` the slice's
loads and FMAs, `reduce` the k-slice shuffles and the partials' exchange in
shared memory, `wait_free` the wait for the free phase, `push` the finish
and the pushes to every CTA; then `barrier` the arrive and wait after the
group. `rows` is everything else: norms, attention, the mix and the update.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

from . import _build

PHASES = ("weights", "reduce", "wait_free", "push", "barrier", "arrive")

_COUNTERS = """
static __device__ unsigned long long g_prof[16];
#define PROF_T(var) long long var = clock64()
#define PROF_ADD(i, v) \\
  do { \\
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_prof[i], (unsigned long long)(v)); \\
  } while (0)
#define PROF_CAT2(a, b) a##b
#define PROF_CAT(a, b) PROF_CAT2(a, b)
extern "C" int PROF_CAT(prof_read_, PROF_KERNEL)(unsigned long long* host) {
  return cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}
extern "C" int PROF_CAT(prof_reset_, PROF_KERNEL)() {
  unsigned long long zero[16] = {0};
  return cudaMemcpyToSymbol(g_prof, zero, sizeof(zero));
}
"""

# (anchor, text that replaces it) per source; every anchor must be present
_HEADER = (
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n" + _COUNTERS),
    ("  cg::cluster_group cluster = cg::this_cluster();\n  const Split sp(p.N, nr);",
     "  PROF_T(t0);\n  cg::cluster_group cluster = cg::this_cluster();\n"
     "  const Split sp(p.N, nr);"),
    ("  for (int o = nq * sp.RS; o < 32; o <<= 1)",
     "  PROF_T(t1);\n  for (int o = nq * sp.RS; o < 32; o <<= 1)"),
    ("  __syncthreads();\n  if (wait_free) cluster_wait();\n",
     "  __syncthreads();\n  PROF_T(t2);\n  if (wait_free) cluster_wait();\n  PROF_T(t3);\n"),
    ("      *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, d)) = v;\n  }\n}",
     "      *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, d)) = v;\n  }\n"
     "  PROF_T(t4);\n  PROF_ADD(0, t1 - t0); PROF_ADD(1, t2 - t1); PROF_ADD(2, t3 - t2);\n"
     "  PROF_ADD(3, t4 - t3);\n}"),
    ("  cluster_arrive_relaxed();  // this CTA is done",
     "  PROF_T(f0);\n  cluster_arrive_relaxed();\n  PROF_T(f1);\n"
     "  PROF_ADD(5, f1 - f0);  // done"),
    ("  cluster_arrive();  // every push of this CTA is done\n  cluster_wait();\n}",
     "  PROF_T(b0);\n  cluster_arrive();\n  cluster_wait();\n  PROF_T(b1);\n"
     "  PROF_ADD(4, b1 - b0);\n}"),
)
_KERNEL = (
    ("  extern __shared__ __align__(16) float smem[];",
     "  PROF_T(k0);\n  extern __shared__ __align__(16) float smem[];"),
    ("  if (blockIdx.x % CLUSTER == 0)  // every CTA",
     "  PROF_T(k1);\n  PROF_ADD(6, k1 - k0);\n  if (blockIdx.x % CLUSTER == 0)  // every CTA"),
)


def _patch(text: str, edits) -> str:
    for anchor, new in edits:
        if text.count(anchor) != 1:
            raise RuntimeError(f"ddim_profile: the source no longer has one {anchor!r}")
        text = text.replace(anchor, new)
    return text


# each DDIM translation unit and the counters' name in it: the T = 1
# instances' are the ones read
_UNITS = {"ddim_md_t1.cu": "md", "ddim_md.cu": "md_general", "ddim_tok_t1.cu": "tok",
          "ddim_tok.cu": "tok_general"}


def instrumented_sources() -> dict:
    """File name -> instrumented text of the DDIM kernel sources."""
    out = {name: (_build.CSRC / name).read_text()
           for name in (*_UNITS, "refusals.cuh")}
    out["ddim_common.cuh"] = _patch((_build.CSRC / "ddim_common.cuh").read_text(), _HEADER)
    for name in ("ddim_md.cuh", "ddim_tok.cuh"):
        out[name] = _patch((_build.CSRC / name).read_text(), _KERNEL)
    return out


def build(tmp: Path, md_threads: int, tok_threads: int) -> ctypes.CDLL:
    for name, text in instrumented_sources().items():
        (tmp / name).write_text(text)
    nvcc = _build.find_nvcc()
    jobs = [(tmp / name, [f"-DPROF_KERNEL={kernel}", "-DDDIM_THREADS="
                          f"{md_threads if name.startswith('ddim_md') else tok_threads}"])
            for name, kernel in _UNITS.items()] + [(_build.CSRC / "pointnet.cu", [])]
    objs = [tmp / f"{src.stem}.o" for src, _ in jobs]
    procs = [subprocess.Popen([nvcc, *_build.NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for (src, flags), obj in zip(jobs, objs)]
    logs = [p.communicate(timeout=_build.BUILD_TIMEOUT)[0] for p in procs]
    if any(p.returncode for p in procs):
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    lib = tmp / "libddim_profile.so"
    subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)], check=True,
                   capture_output=True, timeout=_build.BUILD_TIMEOUT)
    return _build.open_library(lib)


def main() -> None:
    import torch

    from ..diffusion.schedulers import DiffusionSchedule
    from ..models.denoiser import Denoiser
    from ..nn.init import init_parameters_, perturb_parameters_
    from . import denoiser_fused as dfu

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", default="64,1")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--threads", default="256:512")
    args = ap.parse_args()
    pairs = [tuple(int(n) for n in pair.split(":")) for pair in args.threads.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("ddim_profile: needs a CUDA card")
    dev = torch.device("cuda")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = {}
        for pair in pairs:
            (Path(tmp) / f"{pair[0]}_{pair[1]}").mkdir()
            libs[pair] = build(Path(tmp) / f"{pair[0]}_{pair[1]}", *pair)

        def seeded(module, seed):
            init_parameters_(module, torch.Generator().manual_seed(seed))
            perturb_parameters_(module, torch.Generator().manual_seed(seed + 100))
            return module.requires_grad_(False).eval().to(dev).state_dict()

        dens = {"md": seeded(Denoiser((1, 256), ff_size=128, num_layers=5), 3),
                "tok": seeded(Denoiser((1, 256), ff_size=128, num_layers=5,
                                       text_encoded_dim=768, md_trans=False), 6)}
        weights = {"md": dfu.KernelWeights(dens["md"], 5),
                   "tok": dfu.KernelWeights(dens["tok"], 5, md_trans=False)}
        sched = DiffusionSchedule()
        for pair in pairs + pairs[::-1] if len(pairs) > 1 else pairs:
            lib = _build._lib = libs[pair]  # the wrappers launch the instrumented kernels
            for B in (int(b) for b in args.batch.split(",")):
                for kind, g, n_cond, width in (("md", 1.0, 2, 256), ("md", 2.5, 2, 256),
                                               ("tok", 1.0, 1, 768), ("tok", 7.5, 1, 768)):
                    gen = torch.Generator().manual_seed(4)
                    z0 = torch.randn(B, 1, 256, generator=gen).to(dev)
                    cond = torch.randn((2 if g > 1 else 1) * B, n_cond, width,
                                       generator=gen).to(dev)
                    fn = dfu.ddim_fused if kind == "md" else dfu.ddim_fused_tok
                    run = lambda: fn(dens[kind], cond, z0, sched, args.steps, 5, g,  # noqa: E731
                                     weights=weights[kind])
                    run()
                    getattr(lib, f"prof_reset_{kind}")()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    run()
                    end.record()
                    torch.cuda.synchronize()
                    counts = (ctypes.c_ulonglong * 16)()
                    getattr(lib, f"prof_read_{kind}")(counts)
                    total = counts[6]
                    shares = {name: counts[i] / total for i, name in enumerate(PHASES)}
                    shares["rows"] = 1.0 - sum(shares.values())
                    print(json.dumps({"kernel": kind, "threads": pair[0 if kind == "md" else 1],
                                      "batch": B, "guidance": g,
                                      "ms": start.elapsed_time(end), "cycles": total,
                                      "share": {k: round(v, 4) for k, v in shares.items()}}),
                          flush=True)


if __name__ == "__main__":
    main()
