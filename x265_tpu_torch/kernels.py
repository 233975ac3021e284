"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with
a plain C interface and bound through ctypes. Libraries go into the
package's build directory (listed in .gitignore) at first use, named
by a hash of their source, so an edited source rebuilds and parallel
processes never read a half-written file. Beside each library the
build keeps the compiler's report (`-Xptxas -v`: registers, spills and
shared memory of every kernel instance); `resource_usage` reads it and
`sass_opcodes` lists the instructions of the compiled code."""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def _cuda_tool(name: str) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / name
    return str(cand) if cand.exists() else name


def _so_path(name: str) -> Path:
    """Library of csrc/<name>.cu (name may hold a subdirectory)."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"{name.replace('/', '_')}-{tag}.so"


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (final path, temp path, process or None)."""
    so = _so_path(name)
    if so.exists():
        return so, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_cuda_tool("nvcc"), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")],
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
        so.with_suffix(".log").write_text(out)
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
    """Names of every kernel source in csrc/ (not its probes/, which
    measure the card and are no part of the encoder)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def _demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, timeout=60)
    got = out.stdout.splitlines()
    return got if out.returncode == 0 and len(got) == len(names) else names


def resource_usage(name: str) -> list[dict]:
    """Registers, spill bytes and static shared memory of each kernel
    instance in csrc/<name>.cu, as ptxas reported them when it was built
    (empty if the build's report is missing)."""
    log = _so_path(name).with_suffix(".log")
    if not log.exists():
        return []
    rows, cur = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": m.group(1), "registers": None,
                   "spill_stores": None, "spill_loads": None,
                   "stack_bytes": None, "smem_bytes": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = \
                (int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    for row, full in zip(rows, _demangle([r["function"] for r in rows])):
        row["function"] = full
    return rows


def sass_opcodes(name: str, full: bool = False,
                 so: Path | None = None) -> dict[str, list[str]]:
    """The opcodes, in order and without modifiers (VABSDIFF4.U8.ACC is
    VABSDIFF4; with full=True, with them), of each kernel in the built
    csrc/<name>.cu (or in the library `so`), from cuobjdump -sass;
    raises if the tool is missing."""
    out = subprocess.run([_cuda_tool("cuobjdump"), "-sass",
                          str(so or _so_path(name))], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    funcs, ops = [], []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            funcs.append(m.group(1))
            ops.append([])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_]*)((?:\.\w+)*)", line)
        if m and ops:
            ops[-1].append(m.group(1) + (m.group(2) if full else ""))
    return dict(zip(_demangle(funcs), ops))
