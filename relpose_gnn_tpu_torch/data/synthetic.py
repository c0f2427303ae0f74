"""Synthetic relocalization-graph data for tests and the learning check.

Port of `relpose_gnn_tpu/data/synthetic.py`.  Batches in the training
tensor contract (images [B, N, H, W, 3] float32, poses [B, N, 6], adj
[B, N, N] bool) and a *learnable* toy task where the image content encodes
the pose: each pose component fills a full-height vertical stripe (all
channels), so the signal survives the backbone's global average pooling
and a model can regress relative poses from pixels.

`synthetic_batch` / `synthetic_batches` are numpy and give the JAX
functions' arrays byte for byte for the same `np.random.default_rng`
seed.  `make_device_batch_fn` makes the same task on the device from a
`torch.Generator` seeded by (seed, step): its draws are the port's own
(`jax.random` cannot be reproduced), its layout and distribution the JAX
generator's.
"""

from __future__ import annotations

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.ops import graph as graph_ops
from relpose_gnn_tpu_torch.retrieval.subsample import fold_in


def synthetic_batch(rng: np.random.Generator, batch_size: int = 8,
                    num_nodes: int = 8, height: int = 256, width: int = 341,
                    learnable: bool = False) -> dict:
    """One batch in the training tensor contract; with `learnable=True`
    the pose components are written as stripes (module docstring)."""
    images = rng.normal(size=(batch_size, num_nodes, height, width, 3))
    images = images.astype(np.float32)
    poses = rng.normal(size=(batch_size, num_nodes, 6)).astype(np.float32)
    poses[..., 3:] *= 0.3  # plausible logq magnitudes
    if learnable:
        w6 = width // 6
        for comp in range(6):
            block = poses[..., comp][..., None, None, None]
            images[:, :, :, comp * w6:(comp + 1) * w6, :] = block
    adj = np.broadcast_to(graph_ops.fc_adjacency(num_nodes),
                          (batch_size, num_nodes, num_nodes)).copy()
    return {"images": images, "poses": poses, "adj": adj}


def synthetic_batches(seed: int, n_batches: int, **kwargs):
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield synthetic_batch(rng, **kwargs)


def make_device_batch_fn(batch_size: int, num_nodes: int, height: int,
                         width: int, learnable: bool = True,
                         device: torch.device | str | None = None):
    """gen(seed, step) -> a batch of the synthetic task made on `device`
    (default: the card), a function of (seed, step) alone: no image
    crosses from the host, and every step gives a new batch, so a
    training run measures generalisation rather than memorisation."""
    device = resolve_device(device)
    adj = torch.from_numpy(np.broadcast_to(
        graph_ops.fc_adjacency(num_nodes),
        (batch_size, num_nodes, num_nodes)).copy()).to(device)
    w6 = width // 6

    def gen(seed: int, step: int) -> dict:
        g = torch.Generator(device=device).manual_seed(fold_in(seed, step))
        images = torch.randn((batch_size, num_nodes, height, width, 3),
                             generator=g, device=device)
        poses = torch.randn((batch_size, num_nodes, 6), generator=g,
                            device=device)
        poses[..., 3:] *= 0.3
        if learnable:
            for comp in range(6):  # full-height stripes, all channels
                images[:, :, :, comp * w6:(comp + 1) * w6, :] = \
                    poses[..., comp][..., None, None, None]
        return {"images": images, "poses": poses, "adj": adj}

    return gen
