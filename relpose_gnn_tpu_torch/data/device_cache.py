"""Stores held on the device: upload a packed store once, gather batches
there.

Port of `relpose_gnn_tpu/data/device_cache.py`.  The host feed
(`data_iterator` -> `device_prefetch`) reads every batch from the memmaps
and uploads it; this feed uploads the whole uint8 store once (a 7-Scenes
training split of 512 8-node graphs at 256x341 is 1.07 GB) and makes batch
assembly an `index_select` on the device.

Exactness: its batches equal the host feed's on the same device bit for
bit, order included.  The permutations come from the same
`np.random.default_rng(seed)` protocol (`batch_indices`), and the gathered
uint8 rows go through the same normalisers the host feed applies
(`make_normalizer`, `normalize_per_record`): normalising by another
expression (a reciprocal multiply) could move the last bit.

One device: batches land on `device`.  Training over several cards keeps
the host feed (ROADMAP.md, the multi-GPU slice).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.data.pipeline import (batch_indices,
                                                 make_normalizer,
                                                 normalize_per_record)
from relpose_gnn_tpu_torch.utils.profiling import span


class DeviceCachedFeed:
    """Wraps a Packed/Concat dataset; `.epoch()` and `.eval_batches()`
    yield normalized batches on `device` (None: the CUDA card) with no
    host-to-device image traffic after the upload."""

    def __init__(self, dataset, device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.n = len(dataset)
        # one full-range batch() reads the memmaps once; a Concat store
        # also gives its per-record statistics here
        host = dataset.batch(np.arange(self.n))
        self._per_record = "norm_mean" in host
        self._tables = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                            self.device) for k, v in host.items()}
        self._normalize = (None if self._per_record else
                           make_normalizer(dataset.mean, dataset.std,
                                           self.device))
        self.nbytes = sum(int(v.nbytes) for v in host.values())

    def _device_batch(self, idx: np.ndarray) -> dict:
        with span("feed.gather"):
            index = torch.from_numpy(np.asarray(idx, np.int64)).to(
                self.device)
            out = {k: torch.index_select(v, 0, index)
                   for k, v in self._tables.items()}
            if self._per_record:
                out["images"] = normalize_per_record(
                    out["images"], out.pop("norm_mean"),
                    out.pop("norm_std"))
            else:
                out["images"] = self._normalize(out["images"])
            return out

    def epoch(self, seed: int, batch_size: int, shuffle: bool = True,
              drop_remainder: bool = True) -> Iterator[dict]:
        """The batches of `data_iterator(ds, batch_size, seed, epochs=1)`
        + `device_prefetch`, in the same order."""
        rng = np.random.default_rng(seed)
        for idx in batch_indices(rng, self.n, batch_size, shuffle,
                                 drop_remainder):
            yield self._device_batch(idx)

    def eval_batches(self, batch_size: int) -> Iterator[tuple[dict, int]]:
        """In store order, the ragged tail included: (batch, rows)."""
        for idx in batch_indices(np.random.default_rng(0), self.n,
                                 batch_size, shuffle=False,
                                 drop_remainder=False):
            yield self._device_batch(idx), len(idx)
