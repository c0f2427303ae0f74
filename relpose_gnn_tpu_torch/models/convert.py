"""JAX parameter trees -> the port's (PoseNetX_R2-named) torch state dict.

`state_dict_from_jax` takes the JAX RelPoseGNN's variables as nested dicts
of numpy arrays (what `jax.device_get` returns) and gives exactly the keys
and values of `relpose_gnn_tpu/models/convert.py::export_relpose_gnn`, as
torch tensors.  `netvlad_state_dict_from_jax` does the same for the
NetVLAD retrieval encoder, with the released `netvlad_vgg16.tar` key names.
`train_state_from_jax` carries a whole JAX TrainState across (weights, BN
statistics, criterion scalars, Adam moments), so that a test can start
both frameworks' trainers from one state.  All are written without jax so
the port never imports it.

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


# torchvision vgg16.features conv layer indices (cfg D)
_VGG16_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def netvlad_state_dict_from_jax(params: Mapping) -> dict:
    """JAX NetVLADEncoder params -> torch state dict with the released
    `netvlad_vgg16.tar` key names (`encoder.{0,2,5,...,28}.weight/bias`,
    `pool.centroids`, `pool.conv.weight`, and `pool.conv.bias` for a
    vladv2 pool): the inverse of the JAX package's `convert_netvlad`."""
    extra = sorted(set(params) - {"encoder", "pool"})
    if extra:
        raise ValueError(f"no netvlad_vgg16.tar counterpart for parameter "
                         f"subtrees {extra}")
    out = {}
    for j, torch_idx in enumerate(_VGG16_CONV_IDX):
        p = params["encoder"][f"conv{j}"]
        out[f"encoder.{torch_idx}.weight"] = _conv(p["kernel"])
        out[f"encoder.{torch_idx}.bias"] = _f32(p["bias"])
    pool = params["pool"]
    out["pool.centroids"] = _f32(pool["centroids"])
    out["pool.conv.weight"] = _conv(pool["assign_conv"]["kernel"])
    if "bias" in pool["assign_conv"]:
        out["pool.conv.bias"] = _f32(pool["assign_conv"]["bias"])
    return out


def _stage_sizes(encoder_params: Mapping) -> tuple:
    """Blocks per stage of a JAX ResNet parameter tree."""
    sizes = []
    for stage in range(1, 5):
        n = sum(1 for k in encoder_params if k.startswith(f"layer{stage}_"))
        if n:
            sizes.append(n)
    return tuple(sizes)


def _scalars(tree: Mapping) -> dict:
    return {k: _f32(v).reshape(()) for k, v in tree.items()}


def _named_param_tree(tree: Mapping, batch_stats: Mapping,
                      stages: tuple) -> dict:
    """A JAX TrainState-shaped tree (params, or an Adam moment of them:
    {"model", "criterion", "criterion_R"}) -> {parameter name: tensor},
    the names of `training/trainer.py::named_param_groups`."""
    model = state_dict_from_jax(tree["model"], batch_stats, stages)
    out = {f"model.{k}": v for k, v in model.items()
           if not k.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))}
    for name in ("criterion", "criterion_R"):
        out.update({f"{name}.{k}": v
                    for k, v in _scalars(tree[name]).items()})
    return out


def _walk(state):
    """Yield the optax states nested in an opt_state (tuples, named
    tuples, MultiSteps' inner state)."""
    yield state
    inner = getattr(state, "inner_opt_state", None)
    if inner is not None:
        yield from _walk(inner)
    elif isinstance(state, tuple) and not hasattr(state, "_fields"):
        for s in state:
            yield from _walk(s)


def train_state_from_jax(params: Mapping, batch_stats: Mapping,
                         opt_state=None) -> dict:
    """A JAX TrainState's parts -> what `training/trainer.py::TrainState.
    load_state_dict` takes.

    params: {"model", "criterion", "criterion_R"} as the JAX
    `create_train_state` lays them out; batch_stats: the model's; both as
    nested dicts of numpy arrays (`jax.device_get`).  opt_state, when
    given: the optax state of `make_optimizer` (any of its forms: with
    `zero_nans`, under `MultiSteps`), numpy leaves; its Adam `mu`, `nu`
    and `count`, the schedule's count and MultiSteps' `mini_step` and
    accumulated gradients carry over.  The step count stays 0."""
    stages = _stage_sizes(params["model"]["encoder"])
    out = {"model": state_dict_from_jax(params["model"], batch_stats,
                                        stages),
           "criterion": _scalars(params["criterion"]),
           "criterion_R": _scalars(params["criterion_R"])}
    if opt_state is None:
        return out
    adam = updates = mini_step = acc = None
    for s in _walk(opt_state):
        fields = getattr(s, "_fields", ())
        if "mu" in fields and "nu" in fields:
            adam = s
        elif "mini_step" in fields:
            mini_step = int(np.asarray(s.mini_step))
            acc = _named_param_tree(s.acc_grads, batch_stats, stages)
        elif "count" in fields:
            updates = int(np.asarray(s.count))
    if adam is None:
        raise ValueError("opt_state holds no Adam state (mu, nu, count)")
    count = int(np.asarray(adam.count))
    mu = _named_param_tree(adam.mu, batch_stats, stages)
    nu = _named_param_tree(adam.nu, batch_stats, stages)
    out["optimizer"] = {
        "adam": {} if count == 0 else {
            k: {"step": torch.tensor(float(count)), "exp_avg": mu[k],
                "exp_avg_sq": nu[k]} for k in mu},
        "updates": count if updates is None else updates,
        "mini_step": mini_step or 0,
        "acc": acc if mini_step else None}
    return out
