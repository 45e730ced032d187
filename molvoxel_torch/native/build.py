"""Build the native host helper ``fastparse.cpp`` with g++ (plain C ABI, bound with ctypes).

The library goes to ``build/molvoxel_torch/libfastparse-<hash>.so`` beside
the package, as the CUDA kernels do (``ops/_build.py``): the hash covers the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded.  Nothing is written into the package's source directory.

    python -m molvoxel_torch.native.build      # build now (else: at first use)
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sysconfig
from pathlib import Path

SRC = Path(__file__).resolve().parent / "fastparse.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "molvoxel_torch"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")


def _cxx() -> str | None:
    cxx = (sysconfig.get_config_var("CXX") or "g++").split()[0]
    return shutil.which(cxx) or shutil.which("g++")


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libfastparse-{digest}.so"


def build(force: bool = False) -> Path | None:
    """Compile fastparse.cpp if its library is missing (or ``force``);
    returns the library's path, or None when there is no compiler or the
    build fails (the callers then use the pure-Python parser)."""
    path = library_path()
    if path.exists() and not force:
        return path
    cxx = _cxx()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)], check=True, capture_output=True, timeout=300)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, path)
    return path


if __name__ == "__main__":
    built = build(force=True)
    print(f"built: {built}" if built else "build FAILED")
