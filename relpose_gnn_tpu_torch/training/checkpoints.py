"""Checkpoints: the whole train state for exact resume, and the reference's
`.pth.tar` both ways.

Port of `relpose_gnn_tpu/training/checkpoints.py`, with `torch.save` in
place of Orbax:

  * `save_checkpoint` writes `TrainState.state_dict()` (model weights, BN
    running statistics, criterion scalars, Adam moments and steps, the
    schedule's count, the accumulated gradients, the step) to
    `logdir/<epoch>/train_state.pt`; `restore_checkpoint` loads it back,
    and training continues as if it had not stopped.
  * `load_torch_weights` warm-starts the model (weights and BN
    statistics) from a reference `.pth.tar`, `strict=True`; the optimizer
    stays fresh, as train.py:214-219 does.
  * `save_torch_checkpoint` writes the reference schema (utils.py:22-31),
    the same file the JAX package's `save_torch_checkpoint` writes; a ViT
    backbone has no place in it and is refused, as the JAX exporter
    refuses it (its train state saves through `save_checkpoint`).
  * `load_vit_weights` warm-starts a ViT-backbone model's `encoder.*`
    from a timm/DINOv2 state dict (models/convert.py::convert_vit),
    leaving the port's `encoder.fc` head at its init.

The port cannot read the JAX package's Orbax directories, and says so when
asked to.
"""

from __future__ import annotations

import os
import os.path as osp
import shutil

import torch

from relpose_gnn_tpu_torch.models.convert import convert_vit
from relpose_gnn_tpu_torch.training.trainer import TrainState

_FILE = "train_state.pt"
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def _epochs(logdir: str) -> list[int]:
    if not osp.isdir(logdir):
        return []
    return sorted(int(d) for d in os.listdir(logdir)
                  if d.isdigit() and osp.isfile(osp.join(logdir, d, _FILE)))


def save_checkpoint(logdir: str, state: TrainState, epoch: int,
                    max_to_keep: int = 5, sd: dict | None = None) -> str:
    """Write the full train state under `logdir/<epoch>/` (through a
    temporary directory, renamed when complete) and keep the newest
    `max_to_keep` epochs.  `sd` is the state's `state_dict()` where the
    caller has it already (gathered whole from the ranks of a model
    axis).  Returns the file's path."""
    final = osp.join(logdir, str(epoch))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(_to_cpu(state.state_dict() if sd is None else sd),
               osp.join(tmp, _FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    for old in _epochs(logdir)[:-max_to_keep]:
        shutil.rmtree(osp.join(logdir, str(old)))
    return osp.join(final, _FILE)


def latest_epoch(logdir: str) -> int | None:
    epochs = _epochs(logdir)
    return epochs[-1] if epochs else None


def restore_checkpoint(logdir: str, state: TrainState,
                       epoch: int | None = None) -> TrainState:
    """Load the train state saved for `epoch` (None: the latest) into
    `state`, in place; returns it."""
    if epoch is None:
        epoch = latest_epoch(logdir)
        if epoch is None:
            if osp.isdir(logdir) and any(
                    d.isdigit() for d in os.listdir(logdir)):
                raise ValueError(
                    f"{logdir} holds epoch directories without "
                    f"{_FILE}: an Orbax checkpoint of the JAX package? "
                    "The port reads only its own checkpoints (and "
                    ".pth.tar files through load_torch_weights)")
            raise FileNotFoundError(f"no checkpoints in {logdir}")
    path = osp.join(logdir, str(epoch), _FILE)
    if not osp.isfile(path):
        raise FileNotFoundError(
            f"{path} does not exist (an Orbax checkpoint of the JAX "
            "package cannot be read by the port)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    state.load_state_dict(sd)
    return state


def read_state_dict(path: str) -> dict:
    """The state dict of a reference checkpoint file (`.pth.tar`, the
    released `netvlad_vgg16.tar`): its `model_state_dict` or `state_dict`
    entry, else the file's whole dict; tensors only (`weights_only`)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model_state_dict", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            return obj[key]
    return obj


def load_torch_weights(state: TrainState, pth_path: str) -> TrainState:
    """Warm-start the model (weights and BN statistics) from a reference
    checkpoint, `strict=True`: a checkpoint of another model config
    raises.  The optimizer and criterion stay as they are."""
    state.model.load_state_dict(read_state_dict(pth_path), strict=True)
    return state


def save_torch_checkpoint(state: TrainState, path: str, epoch: int,
                          lr: float = 1e-4,
                          weight_decay: float = 5e-4) -> str:
    """Export the train state as a reference-schema `.pth.tar`:

        {'epoch': E, 'model_state_dict': <PoseNetX_R2 names>,
         'optim_state_dict': <torch.optim.Adam schema: the reference's
                              three param groups, empty per-param state>,
         'criterion_state_dict': {'sax', 'saq'}}

    The empty Adam state is the reference's own restore semantics
    (train.py:214-219 loads weights only), as in the JAX exporter.  If
    `path` is a directory, the file is `epoch_{:03d}.pth.tar` inside it.
    Returns the written path."""
    if getattr(state.model, "cfg", None) is not None \
            and state.model.cfg.backbone == "vit":
        raise ValueError(
            "a ViT backbone has no place in the reference PoseNetX_R2 "
            "schema (only the ResNet-backbone RelPoseGNN family is "
            "representable there, as the JAX exporter says); save the "
            "train state with save_checkpoint")
    if osp.isdir(path):
        path = osp.join(path, "epoch_{:03d}.pth.tar".format(epoch))
    model_sd = {k: v.detach().cpu().contiguous()
                for k, v in state.model.state_dict().items()}
    n_learnable = sum(1 for k in model_sd if not k.endswith(_BUFFERS))
    group_hp = dict(lr=lr, betas=(0.9, 0.999), eps=1e-8,
                    weight_decay=weight_decay, amsgrad=False)
    optim_sd = {"state": {},
                "param_groups": [
                    dict(group_hp, params=list(range(n_learnable))),
                    dict(group_hp, params=[n_learnable, n_learnable + 1]),
                    dict(group_hp,
                         params=[n_learnable + 2, n_learnable + 3])]}
    crit_sd = {k: torch.tensor(float(state.criterion[k].detach()))
               for k in ("sax", "saq")}
    torch.save({"epoch": int(epoch), "model_state_dict": model_sd,
                "optim_state_dict": optim_sd,
                "criterion_state_dict": crit_sd}, path)
    return path


def load_vit_weights(state: TrainState, pth_path: str, heads: int = 12,
                     grid_hw: tuple[int, int] | None = None) -> TrainState:
    """Warm-start a ViT-backbone model's encoder (`state.model.encoder`)
    from a timm/DINOv2-style checkpoint (models/convert.py::convert_vit).

    The `fc` projection head has no pretrained counterpart and stays as it
    is; every other encoder tensor must be covered exactly, as the JAX
    `load_vit_weights` holds it: LayerScale gammas on a model built
    without them raise, and so does any key of the encoder left uncovered,
    any checkpoint key it lacks and any shape that differs.  `grid_hw`
    resizes the checkpoint's `pos_embed` to the model's patch grid (needed
    whenever the sizes differ: a 224px table loaded at 256x341/p16 needs
    grid_hw=(16, 21))."""
    sd, layer_scale = convert_vit(read_state_dict(pth_path), heads=heads,
                                  grid_hw=grid_hw)
    enc = state.model.encoder
    own = enc.state_dict()
    if layer_scale and "blocks.0.ls1.gamma" not in own:
        raise ValueError(
            "checkpoint carries DINOv2 LayerScale gammas but the model "
            "was built without them — set "
            "RelPoseGNNConfig.vit_layer_scale=True (or "
            "ViTEncoder(layer_scale=True)) and rebuild")
    for k, v in sd.items():
        if k not in own:
            raise ValueError(
                f"checkpoint key {k} does not exist in the built ViT "
                "encoder — depth/width/layer-scale config mismatch")
        if tuple(own[k].shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch at {k}: model {tuple(own[k].shape)} vs "
                f"checkpoint {tuple(v.shape)}"
                + (" — pass grid_hw to interpolate pos_embed"
                   if k == "pos_embed" else ""))
    missing = sorted(set(own) - set(sd))
    if missing != ["fc.bias", "fc.weight"]:
        raise ValueError(
            "checkpoint does not cover the built encoder: missing "
            f"{[m for m in missing if not m.startswith('fc.')][:6]} "
            "(only the from-scratch fc head may be uncovered)")
    enc.load_state_dict(sd, strict=False)
    return state
