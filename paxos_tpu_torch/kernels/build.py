"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``kernels/csrc/<name>.cu`` compiles on first use into a shared library
with a plain C interface under ``build/`` at the repository root, named by
a hash of the source and of the headers it includes (``#include "..."``,
followed recursively), so an edited source or header rebuilds.  Nothing is built when a
module is imported: only a kernel launch asks for its library.  The
``ptxas -v`` report (registers, spills) is kept beside the library.
``defines`` build a variant of a source (``-D<NAME>``) into its own
library, such as the fused kernels' draw-counting build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every local header it includes, in the order
    first reached."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode() for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return seen


def _flags(defines: tuple) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: tuple = ()) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(_flags(defines)).encode())
    variant = "".join(f"_{d.lower()}" for d in defines)
    return BUILD_DIR / f"{name}{variant}_{digest.hexdigest()[:12]}.so"


def build(name: str, defines: tuple = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def ptxas_report(name: str, defines: tuple = ()) -> str:
    """The ``ptxas -v`` output recorded when ``name`` was built."""
    path = library_path(name, defines).with_suffix(".ptxas.txt")
    return path.read_text() if path.exists() else ""


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name, defines)))
