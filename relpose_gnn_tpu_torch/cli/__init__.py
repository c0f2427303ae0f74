"""The port's train and test entry points.

    python -m relpose_gnn_tpu_torch.cli.train --dataset 7Scenes \\
        --experiment 2 --train-scene chess --test-scene chess \\
        --train-data-dir graphs/ --test-data-dir graphs/
    python -m relpose_gnn_tpu_torch.cli.test --dataset 7Scenes \\
        --test-scene chess --test-data-dir graphs/ \\
        --weights-filename outputs/7Scenes/chess/<exp>/ckpt

Counterparts of the JAX package's `cli/train.py` and `cli/test.py`: the
same flags, defaults, choices and experiment names, plus `--device`
(default: the CUDA card; `cpu` must be asked for).  A flag whose work the
port does not have yet raises NotImplementedError naming the ROADMAP.md
slice that brings it; nothing runs on the CPU in its place.
"""

from __future__ import annotations

import os
import os.path as osp

from relpose_gnn_tpu_torch.training import checkpoints as ckpt


def add_device_arg(p) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' must "
                        "be asked for)")


def refuse_unported(args) -> None:
    """Raise NotImplementedError for a flag the port cannot honour yet."""
    if getattr(args, "coordinator", "") or getattr(
            args, "num_processes", 1) > 1 or args.mesh_data > 0:
        raise NotImplementedError(
            "--coordinator / --num-processes > 1 / --mesh-data > 0: "
            "training and evaluation over several cards are ROADMAP.md "
            "queue 1, slice 7 (multi-GPU)")
    if args.backbone == "vit":
        raise NotImplementedError(
            "--backbone vit: the ViT encoder is ROADMAP.md queue 1, "
            "slice 8 (the rest of the model zoo)")
    w = args.weights_filename
    if w and osp.isdir(w) and ckpt.latest_epoch(w) is None and any(
            d.isdigit() for d in os.listdir(w)):
        raise NotImplementedError(
            f"--weights-filename {w}: epoch directories without the "
            "port's train_state.pt, an Orbax checkpoint of the JAX "
            "package; reading those is ROADMAP.md queue 1, slice 6c (the "
            "parity entry point).  The port reads its own checkpoint "
            "directories and .pth.tar files")
