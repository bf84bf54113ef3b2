"""nvcc build and ctypes load shared by the hand-written CUDA kernels.

Each source in ``csrc/`` is compiled with nvcc for ``sm_90a`` into its own
shared library with a plain C interface, ``build/lib<stem>_<key>.so`` at
the repository root, at first use; ``key`` hashes the source, the
headers beside it (``csrc/*.cuh``) and the flags, so an edit to any of
them builds a new library. nvcc's output (with
``-Xptxas -v``: registers, shared memory and spills per kernel) is kept
beside the library as ``.log`` and returned by :func:`log`.

The build directory is the port's persistent kernel cache: a process
that finds a library there loads it and runs no nvcc.
:func:`use_build_dir` points it elsewhere; :data:`stats` counts the
builds, the libraries found already built, and the seconds spent
building and loading.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"  # the default
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_libs: dict = {}
_build_dir: Optional[Path] = None
# nvcc runs, libraries found already built, and seconds in build + load
stats = {"builds": 0, "hits": 0, "seconds": 0.0}


def build_dir() -> Path:
    """Where libraries are built and looked for: the directory given to
    :func:`use_build_dir`, else ``build/`` at the repository root."""
    return BUILD_DIR if _build_dir is None else _build_dir


def use_build_dir(path) -> Path:
    """Build and look for libraries in ``path`` from now on (``None``:
    back to the default); returns the directory in use."""
    global _build_dir
    _build_dir = None if path is None else Path(path).resolve()
    return build_dir()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built on first use")
    return path


def library_path(source: Path, flags=NVCC_FLAGS) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return build_dir() / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build(source: Path, flags=NVCC_FLAGS) -> Path:
    """Compile ``source`` into the build directory unless a library built
    from the same source and flags is already there; returns its path."""
    t0 = time.perf_counter()
    lib = library_path(source, flags)
    if lib.exists():
        stats["hits"] += 1
        stats["seconds"] += time.perf_counter() - t0
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    proc = subprocess.run([nvcc(), *flags, "-o", tmp, str(source)],
                          capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {source}:\n{text}")
    lib.with_suffix(".log").write_text(text)
    os.replace(tmp, lib)
    stats["builds"] += 1
    stats["seconds"] += time.perf_counter() - t0
    return lib


def log(source: Path, flags=NVCC_FLAGS) -> str:
    """nvcc's output for the library built from ``source``, or '' when it
    has not been built."""
    path = library_path(source, flags).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(source: Path, flags=NVCC_FLAGS) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if need be; one
    handle per library for the life of the process."""
    lib = library_path(source, flags)
    if lib not in _libs:
        build(source, flags)
        t0 = time.perf_counter()
        _libs[lib] = ctypes.CDLL(str(lib))
        stats["seconds"] += time.perf_counter() - t0
    return _libs[lib]
