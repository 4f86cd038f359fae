"""Builds the CUDA sources in ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). The hash covers the source and the flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing is built at import:
the first kernel launch builds its library, and ``build_all`` builds several
at once (one nvcc process per source).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile_cmd(name: str, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names, verbose: bool = False) -> dict[str, float]:
    """Compile every stale library among ``names`` in parallel; returns the
    seconds each compile took (0.0 for a library already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    times = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            times[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _compile_cmd(name, tmp)
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            print(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what} failed with CUDA error {status}")
