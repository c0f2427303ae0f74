"""Model registry: every model family of the reference, by name (PyTorch).

Port of `relpose_gnn_tpu/models/zoo.py`: the same names and aliases
(`MODEL_NAMES`), the same defaults and overrides.  Graph models ('R1' |
'light_knn', 'R2', 'R3', 'R3-vit', 'R3-32' and the PoseNetX family) take
[B, N, H, W, 3] graph batches with adj [B, N, N]; the baselines
('posenet', 'posenet-nolog', 'atloc', 'atloc-lstm') take [B, H, W, 3];
the sequence baselines ('mapnet', 'atloc+') take [B, T, H, W, 3].

`build_model` returns the model on `device` (None: the CUDA card,
`default_device()`, as for every entry point) with weights drawn from
`seed` as flax initialises the JAX model (models/posenet.py::
init_weights), in eval mode.  Unknown names raise ValueError.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.models.atloc import (AtLoc, AtLocPlus, MapNet,
                                                PoseNet, PoseNetNoLog)
from relpose_gnn_tpu_torch.models.legacy import (PoseNetX, PoseNetX2,
                                                 PoseNetXLight, PoseNetXOX,
                                                 PoseNetXR4)
from relpose_gnn_tpu_torch.models.pair_encoder import RelPoseGNNPairEncoder
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)

MODEL_NAMES = ("R1", "light_knn", "R2", "R3", "R3-vit", "R3-32",
               "posenetx", "posenetx2", "posenetx3", "posenetx-light",
               "posenetxox", "posenetx-r4",
               "posenet", "posenet-nolog",
               "mapnet", "atloc", "atloc-lstm", "atloc+")

# graph presets: (RelPoseGNNConfig preset, extra fields)
_GRAPH = {"r1": ("R1", {}), "light_knn": ("R1", {}), "r2": ("R2", {}),
          "r3": ("R3", {}), "r3-vit": ("R3", {"backbone": "vit"}),
          "r3-32": ("R3", {"num_nodes": 32})}

_LEGACY = {"posenetx": PoseNetX, "x": PoseNetX,
           "posenetx2": PoseNetX2, "x2": PoseNetX2,
           "posenetx-light": PoseNetXLight, "light": PoseNetXLight,
           "posenetxox": PoseNetXOX, "xox": PoseNetXOX,
           "posenetx-r4": PoseNetXR4, "r4": PoseNetXR4}


def _construct(name: str, num_nodes: int, knn: int, droprate: float,
               gnn_recursion: int, dtype, overrides: dict) -> nn.Module:
    name = name.lower()
    if name in _GRAPH:
        preset, extra = _GRAPH[name]
        kw = dict(num_nodes=num_nodes, knn=knn, droprate=droprate,
                  gnn_recursion=gnn_recursion, dtype=dtype)
        kw.update(extra)       # r3-32 fixes num_nodes, as the JAX zoo does
        kw.update(overrides)
        return RelPoseGNN(RelPoseGNNConfig.preset(preset, **kw))
    if name in _LEGACY:
        return _LEGACY[name](droprate=droprate, dtype=dtype, use_gnn=True,
                             **overrides)
    if name in ("posenetx3", "x3"):
        return RelPoseGNNPairEncoder(droprate=droprate, dtype=dtype,
                                     **overrides)
    if name == "posenet":
        return PoseNet(droprate=droprate, dtype=dtype, **overrides)
    if name in ("posenet-nolog", "posenet_nolog"):
        return PoseNetNoLog(droprate=droprate, dtype=dtype, **overrides)
    if name == "mapnet":
        return MapNet(droprate=droprate, dtype=dtype, **overrides)
    if name == "atloc":
        return AtLoc(droprate=droprate, dtype=dtype, **overrides)
    if name == "atloc-lstm":
        return AtLoc(droprate=droprate, lstm=True, dtype=dtype, **overrides)
    if name in ("atloc+", "atlocplus"):
        return AtLocPlus(droprate=droprate, dtype=dtype, **overrides)
    raise ValueError(f"unknown model {name!r}")


def build_model(name: str, num_nodes: int = 8, knn: int = 4,
                droprate: float = 0.5, gnn_recursion: int = 2,
                dtype: torch.dtype | None = None,
                device: torch.device | str | None = None, seed: int = 0,
                **overrides) -> nn.Module:
    """The model `name` (case-insensitive, `MODEL_NAMES` and their
    aliases) with the JAX zoo's defaults and `overrides`, on `device`
    (None: the card), seeded weights, eval mode."""
    device = resolve_device(device)
    with torch.device(device):
        model = _construct(name, num_nodes, knn, droprate, gnn_recursion,
                           dtype, overrides)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval()
