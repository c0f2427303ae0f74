"""relpose_gnn_tpu_torch — the PyTorch / CUDA port of relpose_gnn_tpu.

Runs the cached relocalization serving path on one NVIDIA Hopper GPU
(H100, sm_90a).  It mirrors the JAX package's module paths and public
names (`relpose_gnn_tpu/models/gnn.py::DenseEdgeGNN` <->
`relpose_gnn_tpu_torch/models/gnn.py::DenseEdgeGNN`), keeps the JAX
layouts at public functions (images NHWC [B, H, W, 3], nodes [B, N, D],
compact edges [B, E]) and names parameters after the reference PoseNetX_R2
state dict, so `load_state_dict(strict=True)` takes the JAX exporter's
output.

The JAX package is the reference and is never imported here; the only
shared module is the numpy-only `relpose_gnn_tpu.data.packed`.

Subpackages:
  ops         dense graph ops; the attention-core CUDA kernel and its build
  models      ResNet trunk, BN folding, attention, GNN, RelPoseGNN, weights
  data        input normalisation
  training    pose fusion (the trainer arrives with the training slice)
  evaluation  cached-embedding serving and pose errors
"""

__version__ = "0.1.0"
