"""flax `nn.Dense(dtype=...)` semantics on a torch `nn.Linear`.

The JAX modules keep float32 parameters and cast inputs and parameters to
a compute dtype where they are used: `dtype` when given, else the promoted
type of the input and the parameters (so a bfloat16 input meets float32
heads in float32).  Every linear layer of the port applies its weights
through `dense` so that both packages round at the same places.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def dense(x: torch.Tensor, lin: nn.Linear,
          dtype: torch.dtype | None = None) -> torch.Tensor:
    dt = dtype or torch.promote_types(x.dtype, lin.weight.dtype)
    return F.linear(x.to(dt), lin.weight.to(dt), lin.bias.to(dt))
