"""Build the port's CUDA sources at first use and load them with ctypes.

A ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, ``build/<name>-<digest>.so`` beside
this file (``.gitignore`` lists the directory). The digest covers the
source, the shared headers ``csrc/*.cuh`` and the flags, so an edited
source builds anew and a stale library is never loaded. :func:`load`
builds on first use; :func:`build_all` starts one ``nvcc`` per missing
source, all at once, and waits for them. Nothing here runs at import: the
CPU test host has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "load", "build_all",
           "ptxas_report"]

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's ``-Xptxas -v`` report (registers, shared memory, spills) per
#: source built by this process
ptxas_report: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use")


def _source(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no CUDA source {src}")
    return src


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def _start(src: Path, out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def _finish(src: Path, out: Path, proc, tmp: Path) -> None:
    log, _ = proc.communicate()
    ptxas_report[src.stem] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> None:
    """Build every named source that is not built yet, one ``nvcc`` each,
    all started together; raises ``RuntimeError`` naming each failure."""
    with _lock:
        jobs = []
        for name in names:
            src = _source(name)
            out = _target(src)
            if name not in _libs and not out.exists():
                jobs.append((src, out, *_start(src, out)))
        errors = []
        for src, out, proc, tmp in jobs:
            try:
                _finish(src, out, proc, tmp)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built first if it is
    not built yet. Raises ``RuntimeError`` with the compiler's output if
    the build fails."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            src = _source(name)
            out = _target(src)
            if not out.exists():
                _finish(src, out, *_start(src, out))
            lib = _libs[name] = ctypes.CDLL(str(out))
        return lib
