"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/*.cu`` under ``repro_torch/kernels`` compiles to its own shared
library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -ftz=true
         -shared -Xcompiler -fPIC -Xptxas=-v -o _build/lib<name>-<hash>.so <source>

The library lands in ``repro_torch/kernels/_build/`` (listed in
``.gitignore``), named by a hash of its source, of every header it includes
with ``#include "..."`` (``common.cuh``) and of the flags, so an edited
source or header is rebuilt and a built one is reused.  ``build_all``
starts one ``nvcc`` per source, all at once.  Nothing here runs at import time, and there is no
fallback: a failed build raises ``KernelLaunchError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

from repro_torch.resilience.errors import KernelLaunchError

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-ftz=true",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_LIBS: dict = {}
_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources() -> list:
    """Every CUDA source of the port, relative names like
    ``megopolis/csrc/megopolis.cu``."""
    return sorted(str(p.relative_to(KERNELS_DIR)) for p in KERNELS_DIR.glob("*/csrc/*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.is_file() else shutil.which("nvcc")
    if not found:
        raise KernelLaunchError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
    return found


def _with_headers(path: Path, seen: list) -> list:
    """``path`` and every file it includes with quotes, recursively, in
    include order."""
    if path in seen:
        return seen
    seen.append(path)
    for name in _INCLUDE.findall(path.read_bytes()):
        _with_headers((path.parent / name.decode()).resolve(), seen)
    return seen


def _target(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _with_headers((KERNELS_DIR / source).resolve(), []):
        h.update(path.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{Path(source).stem}-{digest}.so"


def _start(source: str):
    """Start ``nvcc`` for one source unless its library exists; returns
    ``(target, process or None)``."""
    target = _target(source)
    if target.is_file():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNELS_DIR / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp = tmp  # type: ignore[attr-defined]
    return target, proc


def _finish(source: str, target: Path, proc) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelLaunchError(f"nvcc failed on {source} (exit {proc.returncode}):\n{log}")
    os.replace(proc.tmp, target)
    return log


def build_all() -> dict:
    """Compile every source that has no current library, one ``nvcc`` per
    source started together; returns ``{source: compiler output}`` (with
    ``ptxas``' registers and spills per kernel)."""
    started = {src: _start(src) for src in sources()}
    return {src: _finish(src, *started[src]) for src in started}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        target, proc = _start(source)
        _finish(source, target, proc)
        lib = _LIBS[source] = ctypes.CDLL(str(target))
    return lib
