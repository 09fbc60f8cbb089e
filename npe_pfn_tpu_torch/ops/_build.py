"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source under ``ops/csrc/`` exposes a plain ``extern "C"``
interface (the sources share ``csrc/*.cuh`` headers), so it compiles in seconds with nvcc alone (no PyTorch headers) into
a shared library that ``ctypes`` loads. Libraries go to the package's
git-ignored ``_build/`` directory, named by a hash of the source and the nvcc
flags, and are built at first use. Nothing here runs at import time.
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

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from ``CUDA_HOME``, then ``/usr/local/cuda``, then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(source: str) -> Path:
    """Where ``source`` (a file name under ``csrc/``) builds to: named by a
    hash of the source, the headers beside it and the flags."""
    src = CSRC_DIR / source
    text = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{src.stem}_{digest[:16]}.so"


def build(source: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<source>`` unless its library exists.

    Returns ``(library path, seconds spent in nvcc (0.0 if cached), the
    compiler's log)``. Raises ``RuntimeError`` carrying nvcc's output if the
    build fails.
    """
    out = library_path(source)
    log_path = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}) building {source}:\n"
            f"{' '.join(cmd)}\n{log}"
        )
    log_path.write_text(log)
    os.replace(tmp, out)
    return out, seconds, log


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path, _, _ = build(source)
            lib = ctypes.CDLL(str(path))
            _libs[source] = lib
        return lib
