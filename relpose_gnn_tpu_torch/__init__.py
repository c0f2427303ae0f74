"""relpose_gnn_tpu_torch — the PyTorch / CUDA port of relpose_gnn_tpu.

Runs the relocalization service (retrieval, neighbour selection, cached
GNN step, database growth and snapshots) and training (the train step,
Adam, checkpoints, the experiment loop) on one NVIDIA Hopper GPU (H100,
sm_90a).  It mirrors the JAX package's module paths and public names
(`relpose_gnn_tpu/models/gnn.py::DenseEdgeGNN` <->
`relpose_gnn_tpu_torch/models/gnn.py::DenseEdgeGNN`), keeps the JAX
layouts at public functions (images NHWC [B, H, W, 3], nodes [B, N, D],
compact edges [B, E]) and names parameters after the reference PoseNetX_R2
and `netvlad_vgg16.tar` state dicts, so `load_state_dict(strict=True)`
takes the JAX exporter's output.

The JAX package is the reference and is never imported here, not even its
numpy-only modules: the port keeps its own copy of what it needs
(`data/packed.py`).

Entry points run on the card: `device=None` means `default_device()`,
which raises where there is no CUDA.  `device="cpu"` is an explicit
request, the one the CPU parity tests make.

Subpackages:
  ops         dense graph ops, quaternion algebra, camera geometry,
              pose-graph optimisation, trajectory alignment; the CUDA kernels
              (attention core, with its autograd Function; fused pair MLP;
              attention variants), their wrappers and their build
  models      ResNet trunk, BN folding, attention, GNN layers, RelPoseGNN
              (R1-R3, R3-vit, R3-32), the ViT, the baselines (AtLoc,
              PoseNet, MapNet), the PoseNetX family, the pair encoder, the
              registry of every model (zoo.py), VGG16, NetVLAD, weight and
              train-state conversion
  data        input normalisation, packed graph stores, the training feed,
              sequence metadata
  retrieval   neighbour subsampling, descriptor index, classical ORB-VLAD
  training    criteria, trainer, checkpoints, experiment loop, pose fusion
  evaluation  the relocalization services, cached serving, pose errors
  utils       logging, metrics, seeding, profiling, trajectory plots
  benchmarks  the kernel, service, eval and train benches
  config.py   the whole configuration tree with a JSON round trip
"""

import torch

__version__ = "0.2.0"


def default_device() -> torch.device:
    """The device every entry point uses when the caller names none: the
    current CUDA card.  Raises where there is none; nothing in the port
    carries on on the CPU because it found no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "relpose_gnn_tpu_torch runs on a CUDA device and "
            "torch.cuda.is_available() is False; pass device='cpu' to ask "
            "for the CPU explicitly")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device: torch.device | str | None) -> torch.device:
    """`device` as a torch.device; None means `default_device()`."""
    return default_device() if device is None else torch.device(device)


def require_full_fp32(x: torch.Tensor) -> None:
    """Raise where a float32 product of `x` on the card would take TF32.

    The port's one precision policy: float32 products at full precision,
    TF32 off (torch's default; every entry point pins it for its process,
    `cli.pin_full_fp32`).  The products whose results decide an argmin or
    a ranking (kNN distances, retrieval similarities, VLAD assignments,
    the distance export), where the JAX package pins `Precision.HIGHEST`,
    call this: they refuse a caller's TF32 rather than take it, and never
    change the flag themselves."""
    if (x.is_cuda and x.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: this float32 "
            "product decides a ranking and must run at full precision; set "
            "it to False (the port's entry points do)")

