"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``fgvc_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use into ``build/kernels/lib<name>-<hash>.so`` at the root
of the checkout (``build/`` is git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so <name>.cu

The hash covers the source and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  ``build_all`` starts one nvcc per source,
all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built on first use and "
        "need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)"
    )


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    out = library_path(name)
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, (proc, tmp)


def _finish(name: str, out: Path, pending) -> str:
    if pending is None:
        return ""
    proc, tmp = pending
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source in parallel; returns nvcc's log per name
    (empty where the library was already built)."""
    started = {name: _start(name) for name in names}
    return {
        name: _finish(name, out, pending)
        for name, (out, pending) in started.items()
    }


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
