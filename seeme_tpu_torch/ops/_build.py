"""Build and load the port's CUDA kernels.

One `nvcc` per `seeme_tpu_torch/csrc/*.cu`, all started together, compiles
the sources for `sm_90a`; one more links the objects into one shared library
with a plain C interface, which `ctypes` loads. The library goes to
`seeme_tpu_torch/_build/` (git-ignored), named by a hash of the sources,
headers and flags, and is built at first use. No PyTorch headers are
included, so the build takes seconds. The check-and-build holds an
exclusive file lock in `_build/`, so processes that start together (the
ranks of a data-parallel run) build once: the first builds, the others wait
and load its library.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported launcher; each returns a cudaError_t.
SIGNATURES = {
    "pointnet_input_block": [_P] * 10 + [_I] * 3 + [_P],
    "pointnet_split_block": [_P] * 8 + [_I] * 3 + [_P],
    "ddim_md": [_P] * 8 + [_I] * 9 + [_F, _I, _P],
    "ddim_tok": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
    "ddim_md_info": [_I] * 8 + [_P],
    "ddim_tok_info": [_I] * 7 + [_P],
    "pointnet_info": [_I, _I, _P],
    "gcn_widths": [_I],
    "gcn_input": [_P] * 12 + [_I] * 2 + [_P],
    "gcn_conv": [_P] * 9 + [_I] * 2 + [_P],
    "gcn_output": [_P] * 10 + [_I] * 2 + [_P],
}
BUILD_TIMEOUT = 600  # seconds for the compiles together, and again for the link
REFUSED = 10000  # launchers' codes past this are refusals (csrc/refusals.cuh), not CUDA errors

_lock = threading.Lock()
_lib = None
build_log = ""
build_seconds = None


def find_nvcc() -> str:
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    on_path = shutil.which("nvcc")
    if on_path:
        return on_path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH): "
        "the CUDA kernels of seeme_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"libseeme_kernels_{h.hexdigest()[:16]}.so"


@contextlib.contextmanager
def _build_lock():
    """An exclusive `flock` on `_build/.lock`, across processes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash, across threads and processes) and load
    the kernel library."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        with _build_lock():
            if not path.exists():
                t0 = time.perf_counter()
                build_log = _build(path)
                build_seconds = time.perf_counter() - t0
        _lib = open_library(path)
        return _lib


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its launchers' C signatures."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.seeme_error_string.argtypes = [ctypes.c_int]
    lib.seeme_error_string.restype = ctypes.c_char_p
    return lib


def _build(path: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    place; return the compilers' output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_sources(), objs)]
        deadline = time.monotonic() + BUILD_TIMEOUT
        log, failed = [], []
        try:
            for src, proc in zip(_sources(), procs):
                out, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
                log.append(f"== {src.name}\n{out}")
                if proc.returncode != 0:
                    failed.append(src.name)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "".join(log))
        lib = Path(tmp) / path.name
        link = subprocess.run([nvcc, "-shared", "-o", str(lib), *map(str, objs)],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "".join(log))
        os.replace(lib, path)
    return "".join(log)


def check(err: int, name: str, call: str = "") -> None:
    """Raise if a launcher returned non-zero: ValueError, naming the limit,
    for a refusal (`call` describes the arguments), else RuntimeError with
    the cudaError_t."""
    if err == 0:
        return
    msg = load_library().seeme_error_string(err).decode()
    if err > REFUSED:
        raise ValueError(f"{name}: {call}: {msg}" if call else f"{name}: {msg}")
    raise RuntimeError(f"{name}: CUDA launch failed: cudaError_t {err} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as the launchers take it."""
    return torch.cuda.current_stream(device).cuda_stream
