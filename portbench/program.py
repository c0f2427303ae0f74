"""The system under test, reached through its public entries only.

`pose_model` and `netvlad_model` build the port's modules for a
configuration file and load the benchmark's weights into them
(`load_state_dict(strict=True)`, so a renamed or reshaped parameter fails
loudly).  Nothing here writes a private attribute of the program.
"""

from __future__ import annotations

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def model_overrides(m: dict) -> dict:
    """RelPoseGNNConfig fields of config file section `model`: the common
    ones, then those of its optional `program` section as they stand (a
    JSON list as a tuple), so that an encoder's own fields reach the
    program with no edit here."""
    out = dict(backbone=m["backbone"], feat_dim=m["feat_dim"],
               edge_dim=m["edge_dim"], node_dim=m["node_dim"],
               num_nodes=m["num_nodes"], knn=m["knn"],
               gnn_recursion=m["gnn_recursion"], num_gnn_layers=1,
               dtype=_DTYPES[m["dtype"]], droprate=m["droprate"],
               vit_image_hw=tuple(m["image_hw"]))
    out.update({k: tuple(v) if isinstance(v, list) else v
                for k, v in m.get("program", {}).items()})
    return out


def pose_model(m: dict, weights: dict, device):
    """The port's RelPoseGNN of config section `m` (unfolded, dense edges:
    the service folds and compacts it itself) with `weights`."""
    from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                      RelPoseGNNConfig)
    cfg = RelPoseGNNConfig.preset(m["preset"], **model_overrides(m))
    with torch.device(device):
        model = RelPoseGNN(cfg)
    model.load_state_dict(weights, strict=True)
    return model


def netvlad_model(r: dict, weights: dict, device, dtype: str):
    from relpose_gnn_tpu_torch.models.netvlad import NetVLADEncoder
    with torch.device(device):
        enc = NetVLADEncoder(num_clusters=r["num_clusters"],
                             encoder_dim=r["encoder_dim"],
                             dtype=_DTYPES[dtype])
    enc.load_state_dict(weights, strict=True)
    return enc
