"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
its own plain-C shared library ``_build/lib<name>.so``, loaded with
ctypes.  ``build_kernels`` starts one ``nvcc`` per source, all at once.
``library(name)`` builds at first use, and rebuilds every library when
any of them is missing or older than its source or a shared
``csrc/*.cuh`` header; nothing is compiled
when a module is imported.  Each library is written under a temporary
name and renamed into place, so concurrent builders never load a
half-written file.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path(source: Path) -> Path:
    return BUILD_DIR / f"lib{source.stem}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        f"nvcc not found: the CUDA kernels are built from {CSRC} on a "
        "machine with the CUDA toolkit")


def build_kernels() -> Dict[str, Tuple[Path, float, str]]:
    """Compile every ``csrc/*.cu`` in parallel.  Returns, per source name,
    (library path, seconds, ptxas report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    t0 = time.perf_counter()
    for src in sources():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", tmp, str(src)]
        jobs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    out, errors = {}, []
    for src, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, library_path(src))
            out[src.stem] = (library_path(src), time.perf_counter() - t0,
                             stderr)
        else:
            errors.append(f"nvcc {src.name} failed ({proc.returncode}):\n"
                          f"{stdout}\n{stderr}")
        if os.path.exists(tmp):
            os.unlink(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _stale() -> bool:
    headers = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")),
                  default=0.0)
    for src in sources():
        lib = library_path(src)
        if not lib.exists() or lib.stat().st_mtime < max(
                src.stat().st_mtime, headers):
            return True
    return False


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``."""
    if _stale():
        build_kernels()
    return ctypes.CDLL(str(library_path(CSRC / f"{name}.cu")))


def check_cuda(t: torch.Tensor, shape, dtype, name: str,
               align: int = 16) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: expected a CUDA tensor, got "
                           f"{t.device} (only CPU tensors take the plain "
                           "version)")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{name}: must be contiguous and {align}-byte "
                         "aligned")


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")
