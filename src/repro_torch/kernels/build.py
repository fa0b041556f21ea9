"""Build the CUDA kernels of `csrc/` with nvcc on first use, load them with
ctypes.

Each `csrc/<name>.cu` exposes a plain C entry point (no PyTorch headers), so
one `nvcc` call per source takes seconds.  Libraries land in `_build/` beside
this package (listed in `.gitignore`) under a name keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one is
reused.  `build()` starts one nvcc per source at once and waits for all.

A failed build raises: there is no fallback to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("gf_matmul", "gf_matmul_small", "ntt")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, PATH, /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are compiled from src/repro_torch/csrc on first use")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to (keyed by source and flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source that is not built yet, one nvcc each, all
    started together.  Returns {name: compiler output} for those compiled
    (register and shared-memory use per kernel, from `-Xptxas=-v`)."""
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = {}
    for name, (so, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half
        logs[name] = out
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def entry(name: str, symbol: str, argtypes: list):
    """The C launch function `symbol` of `csrc/<name>.cu`, typed: pointers
    and the stream as `c_void_p` (ctypes would pass a bare int as 32 bits),
    returning the launch's `cudaError_t` as an int."""
    fn = getattr(load(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
