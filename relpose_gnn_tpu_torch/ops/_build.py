"""Build the port's CUDA kernels on first use and load them with ctypes.

Each kernel source `csrc/<name>.cu` has a plain `extern "C"` interface.  It
is compiled with `nvcc` into `_build/lib<name>-<hash>.so`, where the hash
covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  `_build/` is listed in `.gitignore`: a fresh
checkout builds from its own sources.  The same compile-on-first-use idea as
`relpose_gnn_tpu/data/native_io.py` uses for `native/graphio.cc`.

Nothing here runs at import: the CPU tests import every module, and only a
machine with `nvcc` and a card calls `load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels can only be built where the CUDA "
            "toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed by a hash of source+flags."""
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built.

    The compiler's output (with `-Xptxas=-v`: registers, shared memory and
    spills per kernel) is kept beside the library as `<lib>.log`.  Raises
    RuntimeError with the command line and stderr if nvcc fails."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent build never sees
    # (or loads) a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; one handle per process."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib
