"""The benchmark's plain reference of its configurations, in plain PyTorch.

A frozen copy of the mathematics the program is held to: the node
encoders, one file each under `encoders/`, found by the configuration's
backbone (ResNet34 and ResNet18 with BatchNorm in eval or train mode, so
the program's fold is worked out again; ViT-B/16), VGG16 + NetVLAD, the
edge-featured GNN with the attention core's plain form, the neighbour
selection rule of the service, the masked homoscedastic L1 and Adam.
Functional: every function takes the state dict (the benchmark's own
weights, by the parameter names of `params.py`) and a `Precision` saying
where it rounds.

It imports torch and nothing of the program; float32 products run with
TF32 off (`pin_full_fp32`).
"""

import torch


def pin_full_fp32() -> None:
    """float32 products at full precision: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
