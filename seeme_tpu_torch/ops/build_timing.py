"""Time the two ways of building the kernel library from cold, on one machine.

    python -m seeme_tpu_torch.ops.build_timing [--pairs 2]

"single" is one nvcc over every `csrc/*.cu` that compiles and links in one
process; "parallel" is `_build.py`'s route (one nvcc per source, all started
together, then a link). Each build goes into a fresh temporary directory
under `seeme_tpu_torch/_build/`, in the order single, parallel, parallel,
single for each pair, and the script prints one JSON line of wall seconds
per route. Needs nvcc; no card.
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    routes = {"single": build_single, "parallel": _build._build}
    seconds = {name: [] for name in routes}
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for _ in range(args.pairs):
        for name in ("single", "parallel", "parallel", "single"):
            with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
                t0 = time.perf_counter()
                routes[name](Path(tmp) / "libseeme_kernels.so")
                seconds[name].append(time.perf_counter() - t0)
    print(json.dumps({"sources": [s.name for s in _build._sources()], "seconds": seconds}))


if __name__ == "__main__":
    main()
