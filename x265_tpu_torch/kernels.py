"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with
a plain C interface and bound through ctypes. Libraries go into the
package's build directory (listed in .gitignore) at first use, named
by a hash of their source, so an edited source rebuilds and parallel
processes never read a half-written file."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def _so_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"{name}-{tag}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (final path, temp path, process or None)."""
    so = _so_path(name)
    if so.exists():
        return so, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so, tmp, proc


def build(names) -> float:
    """Compile the named kernels, one nvcc process per source, all
    started together. Returns the wall seconds spent. Raises with the
    compiler's output on failure."""
    t0 = time.perf_counter()
    jobs = [(n, *_start_build(n)) for n in names]
    errors = []
    for name, so, tmp, proc in jobs:
        if proc is None:
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed:\n{out}")
            continue
        os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of csrc/<name>.cu, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_so_path(name)))
        _libs[name] = lib
    return lib


def sources() -> list[str]:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
