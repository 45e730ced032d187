"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/molvoxel_torch/lib<name>-<hash>.so``
beside the package (the hash covers the source and the flags, so an edited
source is rebuilt and a stale library is never loaded).  Libraries are built
at first use; ``build_all()`` compiles every missing one, one nvcc process
for each source, all started together.  The compiler's
report (``-Xptxas -v``: registers, shared memory, spills) is kept next to
each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "molvoxel_torch"
BUILD_DIR = DEFAULT_BUILD_DIR  # utils.timing.enable_compilation_cache moves it
SOURCES = ("deposit_fwd", "deposit_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of molvoxel_torch build with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_log(name: str) -> str:
    """The compiler's report for the built library of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every missing library in ``names``, in parallel; returns the
    seconds until each build finished (0.0 for a library that was already
    built).  Every nvcc started is waited for before a failure raises."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    seconds = {name: 0.0 for name in names}
    running = []
    for name in names:
        path = library_path(name)
        if not path.exists():
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((name, path, tmp, proc))
    failed = []
    for name, path, tmp, proc in running:
        report, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{report}")
            continue
        path.with_suffix(".log").write_text(report)
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
