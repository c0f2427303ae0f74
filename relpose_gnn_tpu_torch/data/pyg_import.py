"""Read the reference's torch-geometric graph pickles WITHOUT PyG installed.

The port's own copy of `relpose_gnn_tpu/data/pyg_import.py` (the same
design; the port imports nothing of the JAX package).

The reference materializes one `processed/data_NNNNNN.pt` per query graph
(dataset_7Scenes_multi.py:437-447) — `torch.save` of a
`torch_geometric.data.Data(x, edge_index, y, edge_attr)`.  Evaluating the
released preprocessed graph tars therefore normally requires installing
torch-geometric.  This module instead registers permissive stub classes for
the `torch_geometric.*` pickle references and extracts the tensors from the
unpickled object graph, so `cli.parity` can consume the released tars
with only `torch` present.

Robustness strategy: stub modules create ANY requested class on the fly
(PEP 562 module __getattr__), every stub class accepts arbitrary
constructor/`__setstate__` payloads into `__dict__`, and tensor extraction
does a recursive search for the canonical keys (`x`, `edge_index`, `y`,
`edge_attr`) across `__dict__`s, mappings, and sequences — covering both
PyG 1.x (attributes directly on Data) and PyG 2.x (nested
`_store._mapping`) layouts.
"""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np

_STUB_PREFIX = "torch_geometric"


class _Stub:
    """Accepts any pickle payload; attributes land in __dict__."""

    def __init__(self, *args, **kwargs):
        self.__dict__.update(kwargs)
        if args:
            self.__dict__["_args"] = args

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2 \
                and isinstance(state[0], (dict, type(None))):
            # object.__reduce_ex__ protocol-2 (dict_state, slots_state)
            if state[0]:
                self.__dict__.update(state[0])
            if isinstance(state[1], dict):
                self.__dict__.update(state[1])
        else:
            self.__dict__["_state"] = state


def _stub_module(name: str) -> types.ModuleType:
    mod = types.ModuleType(name)
    created: dict[str, type] = {}

    def __getattr__(attr: str):  # PEP 562: any class name resolves
        if attr.startswith("__"):
            raise AttributeError(attr)
        if attr not in created:
            created[attr] = type(attr, (_Stub,), {"__module__": name})
        return created[attr]

    mod.__getattr__ = __getattr__
    sys.modules[name] = mod
    return mod


def install_pyg_stubs() -> None:
    """Idempotently register torch_geometric stub modules for unpickling.
    No-op if the real torch_geometric is importable."""
    try:
        import torch_geometric  # noqa: F401
        return
    except ImportError:
        pass
    if _STUB_PREFIX in sys.modules:
        return
    for name in (
            "torch_geometric",
            "torch_geometric.data",
            "torch_geometric.data.data",
            "torch_geometric.data.storage",
            "torch_geometric.data.batch",
            "torch_geometric.data.dataset",
    ):
        _stub_module(name)
    # submodule attribute access (pickle uses find_class(module, name))
    sys.modules["torch_geometric"].data = sys.modules["torch_geometric.data"]


_WANTED = ("x", "edge_index", "y", "edge_attr")


def _search(obj, found: dict, depth: int = 0) -> None:
    if depth > 6 or len(found) == len(_WANTED):
        return
    if isinstance(obj, dict):
        for k, v in obj.items():
            if k in _WANTED and k not in found and hasattr(v, "numpy"):
                found[k] = v
            else:
                _search(v, found, depth + 1)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _search(v, found, depth + 1)
    elif isinstance(obj, _Stub):
        _search(obj.__dict__, found, depth + 1)
    elif type(obj).__module__.startswith("torch_geometric"):
        # a REAL torch_geometric object (env has PyG installed, stubs
        # no-op'd): PyG 2.x keeps tensors in BaseStorage objects that are
        # neither dicts nor _Stubs.  Duck-type: direct attribute access
        # first (works for Data in both 1.x and 2.x), then its __dict__.
        for k in _WANTED:
            if k not in found:
                v = getattr(obj, k, None)
                if v is not None and hasattr(v, "numpy"):
                    found[k] = v
        if len(found) < len(_WANTED) and hasattr(obj, "__dict__"):
            _search(dict(obj.__dict__), found, depth + 1)
        mapping = getattr(obj, "_mapping", None)  # BaseStorage payload
        if len(found) < len(_WANTED) and isinstance(mapping, dict):
            _search(mapping, found, depth + 1)


def load_pyg_graph(path: str | Path) -> dict[str, np.ndarray]:
    """One reference graph pickle -> {'x', 'edge_index', 'y'[, 'edge_attr']}
    as numpy arrays."""
    import torch

    install_pyg_stubs()
    obj = torch.load(str(path), map_location="cpu", weights_only=False)
    found: dict = {}
    _search(obj, found)  # handles dict/list/_Stub/real-PyG objects
    if len(found) < 3 and hasattr(obj, "__dict__"):
        _search(dict(obj.__dict__), found)
    missing = [k for k in ("x", "edge_index", "y") if k not in found]
    if missing:
        raise ValueError(f"{path}: missing {missing} in pickle "
                         f"(found {sorted(found)})")
    return {k: np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
            for k, v in found.items()}


def iter_pyg_dir(root: str | Path, img_height: int = 256):
    """Yield graphs from a reference `processed/` directory in file order.

    Each yield is (index, graph_dict) where graph_dict adds:
      images [N, H, W, 3] float32 (normalized pixels, as stored by the
      builder's transform), poses [N, 6], adj [N, N] bool.
    """
    root = Path(root)
    proc = root / "processed" if (root / "processed").is_dir() else root
    files = sorted(proc.glob("data_*.pt"))
    if not files:
        raise FileNotFoundError(f"no data_*.pt under {proc}")
    for f in files:
        g = load_pyg_graph(f)
        x = g["x"]
        n = x.shape[0]
        w = x.shape[1] // (3 * img_height)
        images = x.reshape(n, 3, img_height, w).transpose(0, 2, 3, 1)
        ei = g["edge_index"].astype(np.int64)
        adj = np.zeros((n, n), bool)
        adj[ei[0], ei[1]] = True
        idx = int(f.stem.split("_")[-1])
        yield idx, {"images": images.astype(np.float32),
                    "poses": g["y"].astype(np.float32),
                    "adj": adj, "edge_index": ei}
