"""Build the port's CUDA kernels on first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), under
``rtap_tpu_torch/_build/`` (listed in .gitignore), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                           "the port's CUDA kernels are built from csrc/ at first use")
    return found


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, force: bool = False) -> tuple[Path, str, float]:
    """Compile ``csrc/<name>.cu`` -> (library path, compiler output, build
    seconds). Reuses an existing library of the same source unless `force`."""
    out = _lib_path(name)
    if out.is_file() and not force:
        return out, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {res.returncode}):\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out, (res.stdout + res.stderr).strip(), secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path, _, _ = build(name)
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib
