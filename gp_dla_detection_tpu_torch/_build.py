"""Compile the CUDA sources of ``csrc/`` with nvcc at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is built into a
shared library that ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

The library name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  The
compiler's report (registers, shared memory, spills per kernel) is kept
beside the library as ``.log``.  ``_build/`` is listed in .gitignore.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

__all__ = ["BuiltLibrary", "load_library", "nvcc_path"]

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float   # 0.0 when an up-to-date library was found
    compiler_report: str


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from csrc/ at first "
        "use; put nvcc on PATH or set CUDA_HOME"
    )


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> BuiltLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; raises on failure."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    path = BUILD_DIR / f"lib{name}-{digest}.so"
    report_path = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        report_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent loader never sees half a file
    report = report_path.read_text() if report_path.exists() else ""
    return BuiltLibrary(ctypes.CDLL(str(path)), path, seconds, report)
