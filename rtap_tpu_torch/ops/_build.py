"""Build the port's CUDA kernels and host C libraries on first use.

Each ``csrc/<name>.cu`` compiles with nvcc into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), under
``rtap_tpu_torch/_build/`` (listed in .gitignore), named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. A failed kernel build raises; nothing falls back.

The host parsers of ``native/`` (plain C99, no device code) build with the
system ``cc`` into the same directory by :func:`build_host_c`, under the
same naming; their loader decides what a failed build means.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

CC_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c99")

_loaded: dict[str, ctypes.CDLL] = {}
# serve's dispatch threads may reach a kernel's first use together: one
# builds and loads it, the others wait for that library
_load_lock = threading.Lock()


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
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                path, _, _ = build(name)
                lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def build_host_c(src: Path) -> Path:
    """Compile the host C source `src` with ``cc`` into a shared library in
    BUILD_DIR named by a hash of the source and the flags; reuse it when it
    exists. The library is written to a temp file and renamed into place, so
    concurrent processes may race the build. Raises on any failure (no
    compiler, a compile error)."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(CC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["cc", *CC_FLAGS, "-o", tmp, str(src)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out
