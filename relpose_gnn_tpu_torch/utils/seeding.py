"""Seeding.

Port of `relpose_gnn_tpu/utils/seeding.py` (the reference's
training/train.py:395-400): `seed_everything` seeds the host generators
(Python's `random` and numpy's legacy global state) exactly as the JAX
function does, and in place of the root PRNG key returns an explicit
`torch.Generator` on the given device, seeded alike, for the caller to
pass to every draw; torch's global generators are left as they are.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device


def seed_everything(seed: int, device=None) -> torch.Generator:
    """Seed the host generators; return a generator on `device` (None:
    the card) seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(resolve_device(device)).manual_seed(seed)


def worker_rngs(seed: int, n: int) -> list[np.random.Generator]:
    """Independent numpy generators for host worker threads (the analog of
    the reference's seeded DataLoader workers, testing/test.py:184-194)."""
    root = np.random.SeedSequence(seed)
    return [np.random.default_rng(s) for s in root.spawn(n)]
