"""The port's entry points.

    python -m relpose_gnn_tpu_torch.cli.build_graphs chess train \\
        --data-path raw/ --graph-data-path graphs/ --cross-connect \\
        --netvlad-checkpoint netvlad_vgg16.tar
    python -m relpose_gnn_tpu_torch.cli.train --dataset 7Scenes \\
        --experiment 2 --train-scene chess --test-scene chess \\
        --train-data-dir graphs/ --test-data-dir graphs/
    python -m relpose_gnn_tpu_torch.cli.test --dataset 7Scenes \\
        --test-scene chess --test-data-dir graphs/ \\
        --weights-filename outputs/7Scenes/chess/<exp>/ckpt
    python -m relpose_gnn_tpu_torch.cli.serve --scene chess \\
        --data-path raw/ --weights epoch_199.pth.tar \\
        --netvlad-checkpoint netvlad_vgg16.tar
    python -m relpose_gnn_tpu_torch.cli.parity \\
        --weights relpose_gnn__multi_39.pth.tar --graph-data-dir graphs/
    python -m relpose_gnn_tpu_torch.cli.compute_pose_stats \\
        --data-path Cambridge/ --output pose_stats.txt
    python -m relpose_gnn_tpu_torch.cli.build_vlad_index \\
        --image-glob 'Cambridge/ShopFacade/seq*/*.png' --output vlad.pkl
    python -m relpose_gnn_tpu_torch.cli.build_graphs ShopFacade train \\
        --dataset Cambridge --data-path Cambridge/ --graph-data-path \\
        graphs/ --vlad-index vlad.pkl
    python -m relpose_gnn_tpu_torch.cli.vlad_export --index vlad.pkl \\
        --output dist --format distances
    python -m relpose_gnn_tpu_torch.cli.scenes2seq 7Scenes/chess

Counterparts of the JAX package's `cli/` scripts of the same names: the
same flags, defaults, choices and experiment names, plus `--device`
(default: the CUDA card; `cpu` must be asked for).  Each pins float32
products at full precision for its process (`pin_full_fp32`).  ORB, the
KMeans dictionary, PnP and the trajectory plots are host calls into
OpenCV, scikit-learn and matplotlib, which the card's machine does not
have.  An Orbax checkpoint directory of the JAX package is
refused with NotImplementedError naming the way across; nothing runs on
the CPU in its place.

Over several GPUs, one process per device, each started with the same
flags and its own `--process-id`:

    python -m relpose_gnn_tpu_torch.cli.train ... --mesh-data 2 \
        --coordinator host0:29500 --num-processes 2 --process-id 0

`--coordinator` / `--num-processes` / `--process-id` join the processes
(NCCL on the cards, gloo with `--device cpu`; parallel/multihost.py);
`--mesh-data` counts GLOBAL ranks.  `cli.test` has no such flags (nor has
the JAX script): started by `torchrun --nproc-per-node N`, it joins
through the launcher's environment.  `--local-device-count` is the JAX
package's virtual devices per process: a torch process drives one device,
so a value above 1 is refused with that advice.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import torch
import torch.distributed as dist

from relpose_gnn_tpu_torch.models.netvlad import NetVLADEncoder
from relpose_gnn_tpu_torch.parallel.multihost import initialize
from relpose_gnn_tpu_torch.retrieval.netvlad_index import seeded_encoder
from relpose_gnn_tpu_torch.training import checkpoints as ckpt


def pin_full_fp32() -> None:
    """The port's one precision policy, set for the process by every entry
    point: float32 products at full precision, never TF32
    (`torch.backends.cuda.matmul.allow_tf32`, off by default in torch).
    Library functions never change the flag; those whose products decide
    an argmin or a ranking refuse TF32 (`require_full_fp32`)."""
    torch.backends.cuda.matmul.allow_tf32 = False


def add_device_arg(p) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the CUDA card; 'cpu' must "
                        "be asked for)")


def netvlad_encoder(checkpoint: str, num_clusters: int = 64,
                    dtype: torch.dtype | None = torch.bfloat16,
                    seed: int = 0) -> NetVLADEncoder:
    """VGG16 + NetVLAD with the weights of `checkpoint` (the released
    `netvlad_vgg16.tar` layout, `strict=True`), or drawn from `seed`
    where it is empty (a smoke run: retrieval means nothing then)."""
    if not checkpoint:
        return seeded_encoder(num_clusters, 512, dtype, seed).eval()
    encoder = NetVLADEncoder(num_clusters=num_clusters, encoder_dim=512,
                             dtype=dtype)
    encoder.load_state_dict(ckpt.read_state_dict(checkpoint), strict=True)
    return encoder.eval()


def start_processes(args) -> bool:
    """Join the multi-process job the flags describe
    (`parallel/multihost.py::initialize`; flags absent from a parser count
    as unset).  Returns whether a process group was started here, which
    the caller ends (`end_processes`)."""
    coordinator = getattr(args, "coordinator", "")
    n = getattr(args, "num_processes", 1)
    local = getattr(args, "local_device_count", 0)
    if not (coordinator or n > 1 or local):
        if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return False
        # started by torchrun: its environment names the coordinator
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
        n = int(os.environ["WORLD_SIZE"])
        args = argparse.Namespace(device=args.device,
                                  process_id=int(os.environ["RANK"]))
    initialize(coordinator, n, getattr(args, "process_id", 0),
               local_device_count=local or None, device=args.device)
    return dist.is_initialized()


def end_processes(started: bool) -> None:
    if started:
        dist.destroy_process_group()


def refuse_unported(args) -> None:
    """Raise NotImplementedError for what the port does not read: the
    JAX package's Orbax checkpoint directories, given to `train`, `test`
    or `serve` (a flag absent from a parser counts as unset)."""
    w = getattr(args, "weights_filename", None) or getattr(args, "weights",
                                                           None)
    if w and osp.isdir(w) and ckpt.latest_epoch(w) is None and any(
            d.isdigit() for d in os.listdir(w)):
        raise NotImplementedError(
            f"{w}: epoch directories without the port's train_state.pt, an "
            "Orbax checkpoint of the JAX package, which the port does not "
            "read (Orbax's on-disk format needs tensorstore).  Export it "
            "with the JAX package's training/checkpoints.py::"
            "save_torch_checkpoint: it writes a .pth.tar that the port "
            "reads with strict=True")
