"""Build and load the port's CUDA kernels: ``nvcc`` compiles each source
under ``csrc/`` into a shared library with a plain C interface, loaded with
``ctypes`` at first use (never at import, so the package imports on a
machine without a card or a CUDA toolkit).

Libraries go to ``build/`` at the repository root (listed in
``.gitignore``), named by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is reused within a checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
# per-library build record: {"seconds": float, "log": str, "path": str}
BUILD_INFO: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): "
        "the CUDA kernels are built from source at first use and need the "
        "CUDA toolkit")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    The library is written under a temporary name and renamed into place,
    so a build that dies midway never leaves a truncated library."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if out.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": "(cached)",
                                     "path": str(out)})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{name}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": seconds, "log": proc.stderr + proc.stdout,
                        "path": str(out)}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def build_all(names) -> dict:
    """Build several sources at once: one ``nvcc`` each, all started
    together (a build waits on its compiler process, not on Python)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        futures = {n: ex.submit(build, n) for n in names}
        return {n: f.result() for n, f in futures.items()}
