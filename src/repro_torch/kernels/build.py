"""Build a CUDA source of ``csrc/`` into a shared library and load it.

Each source has a plain C interface and is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into ``build/`` at
the root of the checkout, then loaded with `ctypes`. The library's name
carries a hash of the source, of every shared header ``csrc/*.cuh`` and of
the flags, so an edited source or header is rebuilt and an unchanged tree
is loaded as it is. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of this source exists.
    Writes to a temporary name first, so a concurrent or cut build never
    leaves a half-written library under the final name."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) for {name}.cu:\n"
                           f"{res.stdout}{res.stderr}")
    (BUILD_DIR / f"{name}.ptxas.txt").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))
