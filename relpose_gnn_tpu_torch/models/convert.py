"""JAX parameter trees -> the port's (PoseNetX_R2-named) torch state dict.

`state_dict_from_jax` takes the JAX RelPoseGNN's variables as nested dicts
of numpy arrays (what `jax.device_get` returns) and gives exactly the keys
and values of `relpose_gnn_tpu/models/convert.py::export_relpose_gnn`, as
torch tensors.  It is written without jax so the port never imports it.

Layout rules (inverse of the JAX converter):
  conv   flax kernel [kH, kW, I, O]  ->  torch [O, I, kH, kW]
  linear flax kernel [I, O]          ->  torch [O, I]
  batchnorm scale/bias (params), mean/var (batch_stats)
            -> weight/bias/running_mean/running_var (+ num_batches_tracked)
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

_HEADS = ("fc_xyz", "fc_wpqr", "fc_xyz_R", "fc_wpqr_R")


def _conv(k) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _linear(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(p["kernel"], np.float32).T))
    out[f"{name}.bias"] = _f32(p["bias"])


def _bn(out: dict, name: str, p: Mapping, s: Mapping) -> None:
    out[f"{name}.weight"] = _f32(p["scale"])
    out[f"{name}.bias"] = _f32(p["bias"])
    out[f"{name}.running_mean"] = _f32(s["mean"])
    out[f"{name}.running_var"] = _f32(s["var"])
    out[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def resnet_state_dict_from_jax(params: Mapping, stats: Mapping,
                               stage_sizes: Sequence[int],
                               prefix: str = "") -> dict:
    """JAX ResNet (params, batch_stats) -> torchvision-named entries."""
    out = {f"{prefix}conv1.weight": _conv(params["conv1"]["kernel"])}
    _bn(out, f"{prefix}bn1", params["bn1"], stats["bn1"])
    for stage, num_blocks in enumerate(stage_sizes):
        for block in range(num_blocks):
            t = f"{prefix}layer{stage + 1}.{block}"
            p = params[f"layer{stage + 1}_{block}"]
            s = stats[f"layer{stage + 1}_{block}"]
            out[f"{t}.conv1.weight"] = _conv(p["conv1"]["kernel"])
            out[f"{t}.conv2.weight"] = _conv(p["conv2"]["kernel"])
            _bn(out, f"{t}.bn1", p["bn1"], s["bn1"])
            _bn(out, f"{t}.bn2", p["bn2"], s["bn2"])
            if "downsample_conv" in p:
                out[f"{t}.downsample.0.weight"] = _conv(
                    p["downsample_conv"]["kernel"])
                _bn(out, f"{t}.downsample.1", p["downsample_bn"],
                    s["downsample_bn"])
    if "fc" in params:
        _linear(out, f"{prefix}fc", params["fc"])
    return out


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> dict:
    """JAX RelPoseGNN (variables['params'], variables['batch_stats']) ->
    torch state dict with the reference PoseNetX_R2 keys.

    Raises on parameter subtrees with no PoseNetX_R2 counterpart (such as
    a ViT backbone), like the JAX exporter."""
    known = {"encoder", "proj_edge", "att", *_HEADS,
             *(f"gnn{i}" for i in (1, 2, 3, 4))}
    extra = sorted(set(params) - known)
    if extra:
        raise ValueError(f"no PoseNetX_R2 counterpart for parameter "
                         f"subtrees {extra}")
    out = resnet_state_dict_from_jax(params["encoder"],
                                     batch_stats["encoder"], stage_sizes,
                                     prefix="feature_extractor.")
    _linear(out, "proj_edge", params["proj_edge"])
    for i in (1, 2, 3, 4):
        if f"gnn{i}" not in params:
            continue
        g = params[f"gnn{i}"]
        for jax_name, torch_name in (("edge_mlp", "edge_model.edge_mlp"),
                                     ("msg_mlp", "mlp"),
                                     ("upd_mlp", "mlp_updating")):
            _linear(out, f"gnn{i}.{torch_name}.0", g[jax_name]["fc1"])
            _linear(out, f"gnn{i}.{torch_name}.2", g[jax_name]["fc2"])
        if "att" in g:
            for k in ("g", "theta", "phi", "W"):
                _linear(out, f"gnn{i}.att.{k}", g["att"][k])
    for head in _HEADS:
        if head in params:
            _linear(out, head, params[head])
    if "att" in params:
        for k in ("g", "theta", "phi", "W"):
            _linear(out, f"att.{k}", params["att"][k])
    return out
