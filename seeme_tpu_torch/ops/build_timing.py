"""Time the two ways of building the kernel library from cold, on one machine.

    python -m seeme_tpu_torch.ops.build_timing [--pairs 2] [--each]

"single" is one nvcc over every `csrc/*.cu` that compiles and links in one
process; "parallel" is `_build.py`'s route (one nvcc per source, all started
together, then a link). Each build goes into a fresh temporary directory
under `seeme_tpu_torch/_build/`, in the order single, parallel, parallel,
single for each pair, and the script prints one JSON line of wall seconds
per route. `--each` instead compiles every source alone, one after another,
and prints the wall seconds of each. Needs nvcc; no card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time
from pathlib import Path

from . import _build


def build_single(path: Path) -> None:
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(path),
           *map(str, _build._sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")


def compile_each() -> dict:
    """Source name -> wall seconds of its `nvcc -c` alone."""
    seconds = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        for src in _build._sources():
            t0 = time.perf_counter()
            subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-c", "-o",
                            str(Path(tmp) / f"{src.stem}.o"), str(src)], check=True,
                           capture_output=True, timeout=_build.BUILD_TIMEOUT)
            seconds[src.name] = time.perf_counter() - t0
    return seconds


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--each", action="store_true")
    args = ap.parse_args()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if args.each:
        print(json.dumps({"compile_seconds": compile_each()}))
        return
    routes = {"single": build_single, "parallel": _build._build}
    seconds = {name: [] for name in routes}
    for _ in range(args.pairs):
        for name in ("single", "parallel", "parallel", "single"):
            with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
                t0 = time.perf_counter()
                routes[name](Path(tmp) / "libseeme_kernels.so")
                seconds[name].append(time.perf_counter() - t0)
    print(json.dumps({"sources": [s.name for s in _build._sources()], "seconds": seconds}))


if __name__ == "__main__":
    main()
