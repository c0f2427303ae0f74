"""Build the port's native sources on first use and load them with ctypes.

Each CUDA kernel source `csrc/<name>.cu` has a plain `extern "C"` interface.
It is compiled with `nvcc` into `_build/lib<name>-<hash>.so`, where the hash
covers the source and the flags, so an edited source rebuilds and an
unchanged one is reused.  The host C++ sources `csrc/<name>.cc` (the graph
reader, the image library) build the same way with `g++` (`build_host`).
`_build/` is listed in `.gitignore`: a fresh checkout builds from its own
sources.  Every build writes a private file and renames it into place, so a
concurrent build never sees (or loads) a half-written library.

Nothing here runs at import: the CPU tests import every module, and only a
machine with `nvcc` and a card calls `load`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-ldl")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LIBS: dict[tuple, ctypes.CDLL] = {}


def on_device(device):
    """Context under which a launch goes to CUDA `device`: nothing to do
    when it is the current device already (the usual case, and several
    microseconds cheaper per launch than switching to it)."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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


def _hashed_path(name: str, src: Path, flags: tuple) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + "\0".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _compile(out: Path, head: list, tail: list, tool: str,
             keep_log: bool = False) -> Path:
    """Run `head + ['-o', <private name>] + tail`, then rename the result
    to `out`.  Raises RuntimeError with the command line and stderr if the
    compiler fails; with `keep_log` its output is kept as `<out>.log`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*head, "-o", tmp, *tail]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{tool} failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        if keep_log:
            Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def library_path(name: str, defines: tuple = ()) -> Path:
    """Where `csrc/<name>.cu` builds to, keyed by a hash of source+flags.
    `defines` are preprocessor settings ("NAME=VALUE") of a build that
    differs from the default one, as a bench of a kernel's design steps
    asks for."""
    return _hashed_path(name, CSRC_DIR / f"{name}.cu",
                        NVCC_FLAGS + tuple(f"-D{d}" for d in defines))


def build(name: str, defines: tuple = ()) -> Path:
    """Compile `csrc/<name>.cu` unless its library is already built.

    The compiler's output (with `-Xptxas=-v`: registers, shared memory and
    spills per kernel) is kept beside the library as `<lib>.log`.  Raises
    RuntimeError with the command line and stderr if nvcc fails."""
    out = library_path(name, defines)
    if out.is_file():
        return out
    return _compile(out, [find_nvcc(), *NVCC_FLAGS,
                          *(f"-D{d}" for d in defines)],
                    [str(CSRC_DIR / f"{name}.cu")], "nvcc", keep_log=True)


def host_library_path(name: str, libs: tuple = ()) -> Path:
    """Where the host source `csrc/<name>.cc` builds to (`libs`: the
    linker's `-l` flags)."""
    return _hashed_path(name, CSRC_DIR / f"{name}.cc", GXX_FLAGS + libs)


def build_host(name: str, libs: tuple = ()) -> Path:
    """Compile the host source `csrc/<name>.cc` with g++ unless it is
    built; raises RuntimeError with the command line and the compiler's
    output if g++ fails."""
    out = host_library_path(name, libs)
    if out.is_file():
        return out
    return _compile(out, ["g++", *GXX_FLAGS],
                    [str(CSRC_DIR / f"{name}.cc"), *libs], "g++")


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; one handle per process
    and set of `defines`."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build(name, tuple(defines))))
        _LIBS[key] = lib
    return lib
