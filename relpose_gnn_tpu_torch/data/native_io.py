"""ctypes binding for the native graphio runtime (`csrc/graphio.cc`).

The port's own copy of `relpose_gnn_tpu/data/native_io.py`.  The source
is compiled with `g++` on first use into `_build/libgraphio-<hash>.so`
(the hash covers the source and the flags, as for the CUDA kernels of
`ops/_build.py`); nothing is written anywhere else.  It exposes:
  * `NativeArray`: one mmap'd .npy record store with a multithreaded
    gather;
  * `NativeConcatDataset`: a multi-store view with the `batch()` contract
    of `ConcatPackedDataset`, rows grouped by store;
  * `NativeBatchLoader`: an async double-buffered batch loader over one
    store directory.

`available()` is False where no compiler is present, and the training
feed keeps to the numpy memmaps there.  Indices are checked here before a
pointer reaches the native code.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import os.path as osp
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SRC_PATH = _PKG / "csrc" / "graphio.cc"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where `csrc/graphio.cc` builds to, keyed by source and flags."""
    digest = hashlib.sha256(SRC_PATH.read_bytes()
                            + "\0".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libgraphio-{digest[:16]}.so"


def build() -> Path:
    """Compile the runtime unless it is built; raises RuntimeError with
    the command line and the compiler's output if g++ fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, "-o", tmp, str(SRC_PATH), "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the runtime; one handle per process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.gio_open.restype = ctypes.c_void_p
        lib.gio_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.gio_close.restype = None
        lib.gio_close.argtypes = [ctypes.c_void_p]
        lib.gio_gather.restype = ctypes.c_int
        lib.gio_gather.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int]
        lib.gpf_create.restype = ctypes.c_void_p
        lib.gpf_create.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                   ctypes.POINTER(ctypes.c_uint64),
                                   ctypes.c_int, ctypes.c_int]
        lib.gpf_submit.restype = None
        lib.gpf_submit.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_void_p)]
        lib.gpf_wait.restype = None
        lib.gpf_wait.argtypes = [ctypes.c_void_p]
        lib.gpf_destroy.restype = None
        lib.gpf_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the runtime builds and loads here."""
    try:
        load()
        return True
    except (OSError, RuntimeError):
        return False


def _npy_header(path: str) -> tuple[int, tuple, np.dtype]:
    """A .npy file's (data offset, shape, dtype), read through numpy's
    own memmap of it; C order only."""
    arr = np.load(path, mmap_mode="r")
    if arr.ndim > 1 and not arr.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{path}: only C-ordered arrays are supported")
    return int(arr.offset), tuple(arr.shape), arr.dtype


def _check_indices(indices: np.ndarray, n_records: int, what: str) -> None:
    if len(indices) and (indices.min() < 0 or indices.max() >= n_records):
        raise IndexError(f"{what}: index out of range [0, {n_records})")


class NativeArray:
    """One mmap'd .npy array with a native multithreaded record gather."""

    def __init__(self, path: str):
        self._lib = load()
        offset, shape, dtype = _npy_header(path)
        self.path = path
        self.shape = shape
        self.dtype = dtype
        self.rec_shape = shape[1:]
        self.rec_bytes = int(np.prod(shape[1:], dtype=np.int64)
                             * dtype.itemsize)
        self._h = self._lib.gio_open(path.encode(), offset)
        if not self._h:
            raise OSError(f"gio_open failed: {path}")

    def gather(self, indices: np.ndarray, out: np.ndarray | None = None,
               threads: int = 4) -> np.ndarray:
        """Records `indices` -> [n, *rec_shape], into `out` if given (C
        contiguous, of this array's dtype and size)."""
        indices = np.ascontiguousarray(indices, np.int64)
        _check_indices(indices, self.shape[0], self.path)
        n = len(indices)
        if out is None:
            out = np.empty((n,) + self.rec_shape, self.dtype)
        if (not out.flags["C_CONTIGUOUS"] or out.dtype != self.dtype
                or out.nbytes != n * self.rec_bytes):
            raise ValueError("gather: out must be C-contiguous "
                             f"{self.dtype} of {n} records")
        rc = self._lib.gio_gather(
            self._h, self.rec_bytes,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
            out.ctypes.data_as(ctypes.c_void_p), threads)
        if rc != 0:
            raise OSError(f"gio_gather failed ({rc}): {self.path}")
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.gio_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def _read_meta(root: str) -> dict:
    with open(osp.join(root, "meta.json")) as f:
        return json.load(f)


class NativeConcatDataset:
    """Multi-store view with native block gathers: `batch()` has the keys,
    `mean` / `std`, per-record `norm_mean` / `norm_std` and `__len__` of
    `ConcatPackedDataset.batch`, and is what the training feed uses where
    the runtime builds.

    Rows come back grouped by store: the indices are sorted by store with
    a stable sort (so within a store they keep the order asked), and each
    group is gathered straight into its slice of the output.  For shuffled
    training batches the grouping changes nothing but the row order, and
    it is the JAX package's order row for row.  Each store's header
    `num_graphs` bounds its indices (a store with skipped frames keeps a
    longer preallocated memmap)."""

    KEYS = ("images", "poses", "adj")

    def __init__(self, roots: list[str], threads: int = 4):
        self.threads = threads
        self.parts: list[dict] = []
        sizes, means, stds = [], [], []
        for root in roots:
            meta = _read_meta(root)
            self.parts.append({k: NativeArray(osp.join(root, f"{k}.npy"))
                               for k in self.KEYS})
            sizes.append(int(meta["num_graphs"]))
            means.append(np.asarray(meta["mean"], np.float32))
            stds.append(np.asarray(meta["std"], np.float32))
        self.mean, self.std = means[0], stds[0]
        self._means, self._stds = np.stack(means), np.stack(stds)
        rec0 = self.parts[0]["images"].rec_shape
        if any(p["images"].rec_shape != rec0 for p in self.parts):
            raise ValueError(f"stores {roots} have mixed graph shapes")
        # the gather copies raw record bytes into one buffer: the dtypes
        # must agree exactly
        for k in self.KEYS:
            d0 = self.parts[0][k].dtype
            if any(p[k].dtype != d0 for p in self.parts):
                raise ValueError(
                    f"mixed {k} dtypes across stores {roots}; rebuild "
                    f"with one dtype (PackedGraphWriter dtype=)")
        self._offsets = np.concatenate([[0], np.cumsum(sizes)])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def batch(self, indices: np.ndarray) -> dict:
        indices = np.asarray(indices)
        _check_indices(indices, len(self), "NativeConcatDataset")
        which = np.searchsorted(self._offsets, indices, side="right") - 1
        local = (indices - self._offsets[which]).astype(np.int64)
        order = np.argsort(which, kind="stable")
        which, local = which[order], local[order]
        n = len(indices)
        out = {k: np.empty((n,) + self.parts[0][k].rec_shape,
                           self.parts[0][k].dtype) for k in self.KEYS}
        bounds = np.flatnonzero(np.diff(which)) + 1
        for lo, hi in zip(np.r_[0, bounds], np.r_[bounds, n]):
            if lo == hi:
                continue
            part = self.parts[int(which[lo])]
            for k in self.KEYS:
                part[k].gather(local[lo:hi], out=out[k][lo:hi],
                               threads=self.threads)
        # each row normalises with its own store's header statistics
        out["norm_mean"] = self._means[which]
        out["norm_std"] = self._stds[which]
        return out

    def close(self):
        for p in getattr(self, "parts", []):
            for a in p.values():
                a.close()

    def __del__(self):
        self.close()


class NativeBatchLoader:
    """Async double-buffered batch loader over one packed store:

        loader = NativeBatchLoader(root)
        for batch in loader.epoch(rng, batch_size=8):  # dicts of arrays
            ...
    """

    KEYS = ("images", "poses", "adj")

    def __init__(self, root: str, threads: int = 4):
        self._lib = load()
        self.arrays = {k: NativeArray(osp.join(root, f"{k}.npy"))
                       for k in self.KEYS}
        # the header's num_graphs counts the valid records of a store
        # whose preallocated memmaps are longer (skipped frames)
        self.num_records = self.arrays["images"].shape[0]
        if osp.isfile(osp.join(root, "meta.json")):
            n = _read_meta(root).get("num_graphs")
            if n is not None:
                self.num_records = min(self.num_records, int(n))
        handles = (ctypes.c_void_p * 3)(
            *[self.arrays[k]._h for k in self.KEYS])
        recs = (ctypes.c_uint64 * 3)(
            *[self.arrays[k].rec_bytes for k in self.KEYS])
        self._pf = self._lib.gpf_create(handles, recs, 3, threads)

    def __len__(self):
        return self.num_records

    def _submit(self, indices: np.ndarray) -> dict:
        indices = np.ascontiguousarray(indices, np.int64)
        _check_indices(indices, self.num_records, "NativeBatchLoader")
        bufs = {k: np.empty((len(indices),) + self.arrays[k].rec_shape,
                            self.arrays[k].dtype) for k in self.KEYS}
        ptrs = (ctypes.c_void_p * 3)(
            *[bufs[k].ctypes.data_as(ctypes.c_void_p).value
              for k in self.KEYS])
        self._lib.gpf_submit(
            self._pf,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(indices), ptrs)
        # the buffers and indices stay referenced until gpf_wait returns
        return {"bufs": bufs, "indices": indices, "ptrs": ptrs}

    def epoch(self, rng: np.random.Generator, batch_size: int,
              shuffle: bool = True, drop_remainder: bool = True):
        """One epoch's batches in `batch_indices`' order; the next batch
        is gathered while the caller holds the current one."""
        order = (rng.permutation(self.num_records) if shuffle
                 else np.arange(self.num_records))
        end = (self.num_records - self.num_records % batch_size
               if drop_remainder else self.num_records)
        starts = list(range(0, end, batch_size))
        if not starts:
            return
        pending = self._submit(order[starts[0]:starts[0] + batch_size])
        try:
            for s in starts[1:]:
                self._lib.gpf_wait(self._pf)
                ready = pending["bufs"]
                pending = self._submit(order[s:s + batch_size])
                yield ready
        finally:
            # never leave a gather writing into buffers being released
            self._lib.gpf_wait(self._pf)
        yield pending["bufs"]

    def close(self):
        if getattr(self, "_pf", None):
            self._lib.gpf_destroy(self._pf)
            self._pf = None
        for a in getattr(self, "arrays", {}).values():
            a.close()

    def __del__(self):
        self.close()
