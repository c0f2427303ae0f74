"""JAX parameter trees -> the port's (PoseNetX_R2-named) torch state dict.

`state_dict_from_jax` takes the JAX RelPoseGNN's variables as nested dicts
of numpy arrays (what `jax.device_get` returns) and gives exactly the keys
and values of `relpose_gnn_tpu/models/convert.py::export_relpose_gnn`, as
torch tensors.  `netvlad_state_dict_from_jax` does the same for the
NetVLAD retrieval encoder, with the released `netvlad_vgg16.tar` key names.
`train_state_from_jax` carries a whole JAX TrainState across (weights, BN
statistics, criterion scalars, Adam moments), so that a test can start
both frameworks' trainers from one state.  `vit_state_dict_from_jax`
gives the flax ViTEncoder's tree timm's names (an R3-vit model's
`encoder.*`, through `state_dict_from_jax`), `zoo_state_dict_from_jax`
carries any model of models/zoo.py across.  All are written without jax
so the port never imports it.

The other direction, for a released timm/DINOv2 ViT: `convert_vit` checks
a timm-layout state dict against what the port's ViTEncoder holds,
detects LayerScale and resizes `pos_embed` to the model's patch grid with
`interpolate_pos_embed`, the bicubic resize of `jax.image.resize` (Keys
cubic with a = -0.5, half-pixel centres, antialiased when downsampling;
`F.interpolate(mode="bicubic")` uses a = -0.75 and no antialias, other
numbers).

Layout rules (inverse of the JAX converter):
  conv   flax kernel [kH, kW, I, O]  ->  torch [O, I, kH, kW]
  linear flax kernel [I, O]          ->  torch [O, I]
  batchnorm scale/bias (params), mean/var (batch_stats)
            -> weight/bias/running_mean/running_var (+ num_batches_tracked)
  attention DenseGeneral query/key/value [D, heads, hd] -> fused qkv
            [3D, D]; out [heads, hd, D] -> proj [D, D]
  lstm      OptimizedLSTMCell ii/if/ig/io (no bias), hi/hf/hg/ho (bias)
            -> weight_ih [4H, I], weight_hh [4H, H], bias_ih = 0,
               bias_hh (gates i, f, g, o)
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


def _ln(out: dict, name: str, p: Mapping) -> None:
    out[f"{name}.weight"] = _f32(p["scale"])
    out[f"{name}.bias"] = _f32(p["bias"])


def vit_state_dict_from_jax(params: Mapping, prefix: str = "") -> dict:
    """The flax ViTEncoder's params -> the port's ViTEncoder keys (timm's
    names, plus `fc`) under `prefix`: q, k and v kernels [D, heads, hd]
    fused into `attn.qkv` [3D, D], `out` [heads, hd, D] into `attn.proj`."""
    out = {f"{prefix}cls_token": _f32(params["cls"]),
           f"{prefix}pos_embed": _f32(params["pos_embed"])}
    pe = params["patch_embed"]
    out[f"{prefix}patch_embed.proj.weight"] = _conv(pe["kernel"])
    out[f"{prefix}patch_embed.proj.bias"] = _f32(pe["bias"])
    depth = sum(1 for k in params if k.startswith("block"))
    dim = out[f"{prefix}cls_token"].shape[-1]
    for i in range(depth):
        blk, t = params[f"block{i}"], f"{prefix}blocks.{i}"
        att = blk["MultiHeadDotProductAttention_0"]
        _ln(out, f"{t}.norm1", blk["LayerNorm_0"])
        out[f"{t}.attn.qkv.weight"] = torch.cat([
            _f32(np.asarray(att[k]["kernel"]).reshape(dim, dim).T)
            for k in ("query", "key", "value")])
        out[f"{t}.attn.qkv.bias"] = torch.cat([
            _f32(np.asarray(att[k]["bias"]).reshape(dim))
            for k in ("query", "key", "value")])
        out[f"{t}.attn.proj.weight"] = _f32(
            np.asarray(att["out"]["kernel"]).reshape(dim, dim).T)
        out[f"{t}.attn.proj.bias"] = _f32(att["out"]["bias"])
        if "ls1" in blk:
            out[f"{t}.ls1.gamma"] = _f32(blk["ls1"])
        _ln(out, f"{t}.norm2", blk["LayerNorm_1"])
        _linear(out, f"{t}.mlp.fc1", blk["Dense_0"])
        _linear(out, f"{t}.mlp.fc2", blk["Dense_1"])
        if "ls2" in blk:
            out[f"{t}.ls2.gamma"] = _f32(blk["ls2"])
    _ln(out, f"{prefix}norm", params["norm"])
    _linear(out, f"{prefix}fc", params["fc"])
    return out


def _is_vit(encoder_params: Mapping) -> bool:
    return "patch_embed" in encoder_params


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        stage_sizes: Sequence[int] = (3, 4, 6, 3)) -> dict:
    """JAX RelPoseGNN (variables['params'], variables['batch_stats']) ->
    torch state dict with the reference PoseNetX_R2 keys; a ViT encoder
    (R3-vit) goes to `encoder.*` with timm's names
    (`vit_state_dict_from_jax`), the `use_gnn=False` MLP to `mlp.0/.2`.

    Raises on parameter subtrees with no counterpart, like the JAX
    exporter."""
    known = {"encoder", "proj_edge", "att", "mlp", *_HEADS,
             *(f"gnn{i}" for i in (1, 2, 3, 4))}
    extra = sorted(set(params) - known)
    if extra:
        raise ValueError(f"no PoseNetX_R2 counterpart for parameter "
                         f"subtrees {extra}")
    if _is_vit(params["encoder"]):
        out = vit_state_dict_from_jax(params["encoder"], prefix="encoder.")
    else:
        out = resnet_state_dict_from_jax(params["encoder"],
                                         batch_stats["encoder"], stage_sizes,
                                         prefix="feature_extractor.")
    _linear(out, "proj_edge", params["proj_edge"])
    for i in (1, 2, 3, 4):
        if f"gnn{i}" in params:
            _production_gnn(out, f"gnn{i}", params[f"gnn{i}"])
    if "mlp" in params:
        _mlp2(out, "mlp", params["mlp"])
    for head in _HEADS:
        if head in params:
            _linear(out, head, params[head])
    if "att" in params:
        for k in ("g", "theta", "phi", "W"):
            _linear(out, f"att.{k}", params["att"][k])
    return out


def _mlp2(out: dict, name: str, p: Mapping) -> None:
    """MLP2 / PairMLP2 {fc1, fc2} -> `Seq(Linear, ReLU, Linear)` `.0`/`.2`."""
    _linear(out, f"{name}.0", p["fc1"])
    _linear(out, f"{name}.2", p["fc2"])


def _production_gnn(out: dict, name: str, g: Mapping) -> None:
    """A JAX DenseEdgeGNN (`simpleConvEdge_upt`) -> the reference names."""
    for jax_name, torch_name in (("edge_mlp", "edge_model.edge_mlp"),
                                 ("msg_mlp", "mlp"),
                                 ("upd_mlp", "mlp_updating")):
        _mlp2(out, f"{name}.{torch_name}", g[jax_name])
    if "att" in g:
        for k in ("g", "theta", "phi", "W"):
            _linear(out, f"{name}.att.{k}", g["att"][k])


_LSTM_GATES = "ifgo"


def _lstm_cell(out: dict, name: str, suffix: str, cell: Mapping) -> None:
    """A flax OptimizedLSTMCell -> one direction of a torch LSTM layer
    (`suffix` "" or "_reverse"): bias_ih 0, bias_hh the cell's."""
    w_ih = np.concatenate([np.asarray(cell[f"i{g}"]["kernel"], np.float32)
                           for g in _LSTM_GATES], axis=1)
    w_hh = np.concatenate([np.asarray(cell[f"h{g}"]["kernel"], np.float32)
                           for g in _LSTM_GATES], axis=1)
    b_hh = np.concatenate([np.asarray(cell[f"h{g}"]["bias"], np.float32)
                           for g in _LSTM_GATES])
    out[f"{name}.weight_ih_l0{suffix}"] = _f32(np.ascontiguousarray(w_ih.T))
    out[f"{name}.weight_hh_l0{suffix}"] = _f32(np.ascontiguousarray(w_hh.T))
    out[f"{name}.bias_ih_l0{suffix}"] = torch.zeros(len(b_hh))
    out[f"{name}.bias_hh_l0{suffix}"] = _f32(b_hh)


def _four_dir_lstm(out: dict, name: str, p: Mapping) -> None:
    """FourDirectionalLSTM's cells, in creation order: rightleft forward
    and backward, downup forward and backward."""
    for k, (lstm, suffix) in enumerate((("rightleft", ""),
                                        ("rightleft", "_reverse"),
                                        ("downup", ""),
                                        ("downup", "_reverse"))):
        _lstm_cell(out, f"{name}.{lstm}", suffix,
                   p[f"OptimizedLSTMCell_{k}"])


def _is_resnet(p: Mapping) -> bool:
    return "conv1" in p and "layer1_0" in p


def tree_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                             prefix: str = "", out: dict | None = None
                             ) -> dict:
    """Walk a JAX module's (params, batch_stats) -> the port module's
    state dict: ResNets (torchvision names), the production GNN layer
    (reference names), MLP2 / PairMLP2 (`.0`/`.2`), the four-directional
    LSTM, convolutions, linears and BatchNorms; other subtrees keep their
    JAX names (the baselines, the legacy family, the pair encoder and the
    ablation GNN layers)."""
    out = {} if out is None else out
    for k, v in params.items():
        name, s = f"{prefix}{k}", batch_stats.get(k, {})
        if not isinstance(v, Mapping):
            raise ValueError(f"no port counterpart for parameter {name}")
        if _is_resnet(v):
            out.update(resnet_state_dict_from_jax(v, s, _stage_sizes(v),
                                                  prefix=f"{name}."))
        elif "upd_mlp" in v and "gate_mlp" not in v:
            _production_gnn(out, name, v)
        elif "fc1" in v and "fc2" in v:
            _mlp2(out, name, v)
        elif "OptimizedLSTMCell_0" in v:
            _four_dir_lstm(out, name, v)
        elif "scale" in v:
            _bn(out, name, v, s)
        elif "kernel" in v:
            if np.ndim(v["kernel"]) == 4:
                out[f"{name}.weight"] = _conv(v["kernel"])
                if "bias" in v:
                    out[f"{name}.bias"] = _f32(v["bias"])
            else:
                _linear(out, name, v)
        else:
            tree_state_dict_from_jax(v, s, f"{name}.", out)
    return out


def zoo_state_dict_from_jax(name: str, params: Mapping,
                            batch_stats: Mapping) -> dict:
    """A JAX `models/zoo.py::build_model(name)` model's (params,
    batch_stats) -> the state dict of the port's `build_model(name)`
    (load_state_dict strict=True): the RelPoseGNN presets through
    `state_dict_from_jax`, the baselines, the legacy family and the pair
    encoder through a walk of their trees (Dense, Conv [kH, kW, I, O] ->
    [O, I, kH, kW], BatchNorm, AttentionBlock, MLP2, the LSTM cells)."""
    if name.lower() in ("r1", "light_knn", "r2", "r3", "r3-vit", "r3-32"):
        enc = params["encoder"]
        stages = () if _is_vit(enc) else _stage_sizes(enc)
        return state_dict_from_jax(params, batch_stats, stages)
    return tree_state_dict_from_jax(params, batch_stats)


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


# ---------------------------------------------------------------------------
# ViT (timm / DINOv2 layout) -> the port's ViTEncoder
# ---------------------------------------------------------------------------

def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5 on |x| (the kernel of
    `jax.image.resize(method="bicubic")`)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """The [n_in, n_out] float32 weights of one axis of
    `jax.image.resize(..., "bicubic", antialias=True)`: half-pixel sample
    centres, the kernel widened by n_in / n_out when downsampling, each
    column normalised to sum 1, columns whose centre falls outside the
    input zero (jax/_src/image/scale.py::compute_weight_mat)."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = _keys_cubic(x / np.float32(kernel_scale))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def interpolate_pos_embed(pos, grid_hw: tuple[int, int],
                          old_hw: tuple[int, int] | None = None
                          ) -> torch.Tensor:
    """Resize a [1, 1 + h0*w0, D] position table to the patch grid
    `grid_hw`, bicubic over the grid as `jax.image.resize` does it (see
    the module docstring), the CLS slot untouched; float32.  `old_hw`
    defaults to a square grid (the pretraining shape); a same-size call
    returns the table as it is."""
    pos = np.asarray(pos.detach().cpu() if torch.is_tensor(pos) else pos,
                     np.float32)
    n = pos.shape[1] - 1
    if old_hw is None:
        side = int(round(float(np.sqrt(n))))
        if side * side != n:
            raise ValueError(
                f"pos_embed has {n} patch slots (not square) — pass "
                "old_hw=(h0, w0) explicitly")
        old_hw = (side, side)
    h, w = grid_hw
    if tuple(old_hw) == (h, w):
        return torch.from_numpy(pos.copy())
    # the float32 weights of each axis whose size changes, applied in
    # float64 and rounded once (jax contracts both in one einsum)
    grid = pos[0, 1:].reshape(old_hw[0], old_hw[1], -1).astype(np.float64)
    if old_hw[0] != h:
        grid = np.einsum("hwd,hH->Hwd", grid, resize_weights(old_hw[0], h))
    if old_hw[1] != w:
        grid = np.einsum("hwd,wW->hWd", grid, resize_weights(old_hw[1], w))
    table = np.concatenate([pos[:, :1], grid.reshape(1, h * w, -1)], axis=1)
    return torch.from_numpy(np.ascontiguousarray(table, np.float32))


_VIT_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight",
                   "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
                   "norm2.weight", "norm2.bias", "mlp.fc1.weight",
                   "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


def convert_vit(sd: Mapping, heads: int = 12,
                grid_hw: tuple[int, int] | None = None,
                pos_old_hw: tuple[int, int] | None = None
                ) -> tuple[dict, bool]:
    """A timm/DINOv2-layout ViT state dict -> (the port's ViTEncoder
    entries, layer_scale).

    The port keeps timm's names and its fused `qkv`, so nothing is split:
    every key is read once, LayerScale gammas (`blocks.{i}.ls1.gamma`)
    say which form to build (the returned bool), and `grid_hw` resizes
    `pos_embed` to the target patch grid (e.g. (16, 21) for 256x341 at
    patch 16; `interpolate_pos_embed`).  The `fc` head is the port's own,
    trained from scratch, and is not produced.  A key left unread (DINOv2
    register tokens, a SwiGLU MLP, a non-timm layout) raises, as the JAX
    converter does: a partial warm start would be another network."""
    sd = {k: torch.as_tensor(np.asarray(v.detach().cpu() if
                                        torch.is_tensor(v) else v))
          for k, v in sd.items()}
    depth = 1 + max(int(k.split(".")[1]) for k in sd
                    if k.startswith("blocks."))
    dim = sd["cls_token"].shape[-1]
    if dim % heads:
        raise ValueError(f"width {dim} is not a multiple of heads {heads}")
    layer_scale = "blocks.0.ls1.gamma" in sd
    consumed: set = set()

    def g(name):
        consumed.add(name)
        return sd[name].float()

    out = {"cls_token": g("cls_token"), "pos_embed": g("pos_embed")}
    if grid_hw is not None:
        out["pos_embed"] = interpolate_pos_embed(out["pos_embed"], grid_hw,
                                                 pos_old_hw)
    for k in ("patch_embed.proj.weight", "patch_embed.proj.bias",
              "norm.weight", "norm.bias"):
        out[k] = g(k)
    for i in range(depth):
        keys = _VIT_BLOCK_KEYS + (("ls1.gamma", "ls2.gamma")
                                  if layer_scale else ())
        for k in keys:
            out[f"blocks.{i}.{k}"] = g(f"blocks.{i}.{k}")
    unknown = sorted(set(sd) - consumed)
    if unknown:
        raise ValueError(
            f"convert_vit: {len(unknown)} unconsumed checkpoint keys "
            f"(first few: {unknown[:6]}) — register tokens / SwiGLU / "
            "non-timm layouts are not representable in ViTEncoder; "
            "refusing a silent partial warm start")
    return out, layer_scale
