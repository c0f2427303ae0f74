"""Bottleneck self-attention block over the channel axis (PyTorch).

Port of `relpose_gnn_tpu/models/attention.py::AttentionBlock` (reference
modules/att.py:7-34).  Per item, with C/8-dim projections g, theta, phi:

    y_i = sum_j softmax_j(phi(x)_i * theta(x)_j) * g(x)_j
    z   = x + W(y)

The core runs through `ops.att_core.attention_core`, which picks the CUDA
kernel or the plain version by the tensors' device; there is no other
switch.  In training (grad enabled, weights that require grad) the same
call goes through `att_core.AttentionCoreFunction`: the forward is still
the kernel on the card, the backward the eager mirror of the JAX
`_core_bwd`.  It is looked up on the module at call time, so a check can
substitute `attention_core_plain` (e.g. `unittest.mock.patch.object`).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from relpose_gnn_tpu_torch.models.dense import dense
from relpose_gnn_tpu_torch.ops import att_core


class AttentionBlock(nn.Module):
    """x [..., C] -> x + W(core(phi(x), theta(x), g(x))).

    `dtype` is the compute dtype (None: the promotion of the input's and
    the float32 parameters' types, as flax `nn.Dense(dtype=None)`)."""

    def __init__(self, in_channels: int, dtype: torch.dtype | None = None):
        super().__init__()
        c8 = in_channels // 8
        self.dtype = dtype
        self.g = nn.Linear(in_channels, c8)
        self.theta = nn.Linear(in_channels, c8)
        self.phi = nn.Linear(in_channels, c8)
        self.W = nn.Linear(c8, in_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g_x = dense(x, self.g, self.dtype)
        theta_x = dense(x, self.theta, self.dtype)
        phi_x = dense(x, self.phi, self.dtype)
        lead, c8 = phi_x.shape[:-1], phi_x.shape[-1]
        y = att_core.attention_core(phi_x.reshape(-1, c8),
                                    theta_x.reshape(-1, c8),
                                    g_x.reshape(-1, c8))
        y = y.reshape(*lead, c8).to(g_x.dtype)
        return x + dense(y, self.W, self.dtype)
