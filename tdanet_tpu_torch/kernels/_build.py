"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for sm_90a into a shared
library with a plain C interface, under ``build/tdanet_tpu_torch/`` at the
root of the checkout. The file name carries a hash of the source and the
``csrc/*.cuh`` headers, so an edited source is rebuilt and never meets a
stale library.
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tdanet_tpu_torch"
# -split-compile 0: the device compiler optimises a source's kernels in
# parallel threads (dw_conv_glob_ln.cu holds 64 template instances)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-split-compile", "0"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
            "tdanet_tpu_torch build only where the CUDA toolkit is installed")
    return path


def source_hash(name: str) -> str:
    """A hash of ``csrc/<name>.cu`` and of every header in ``csrc/`` it
    may include: what names its library."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """The library's path, named by :func:`source_hash`."""
    return BUILD_DIR / f"lib{name}-{source_hash(name)}.so"


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library for this exact source
    exists. Returns (library path, build seconds, ptxas report)."""
    so = library_path(name)
    if so.exists():
        return so, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}.cu:\n"
            f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so, seconds, proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Load the library for ``csrc/<name>.cu``, built if needed."""
    so, _, _ = build(name)
    return ctypes.CDLL(str(so))
