"""Input pipeline: batch order, the host feed, upload and normalisation.

Port of `relpose_gnn_tpu/data/pipeline.py`: the host gathers raw uint8
batches from the packed memmaps, the device converts them to normalised
float32.

  * `batch_indices` / `data_iterator` draw the same
    `np.random.default_rng(seed + epoch)` permutations as the JAX
    iterator, so a seed gives the same batch order in both packages;
    `native_data_iterator` gives the same batches through the native
    graphio runtime.
  * `device_prefetch` gathers on a host thread into pinned memory, uploads
    up to `prefetch` batches ahead on a side stream and normalises them
    there; the consumer's stream waits on each batch's event.
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
from typing import Callable, Iterator

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device


def to_float01(images: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 in [0, 1] by TRUE division, bit for bit
    what the host's `images.astype(float32) / 255` gives.  The divisor is
    a tensor on purpose: given a Python scalar, torch's CUDA division
    multiplies by the reciprocal instead, which rounds differently and
    would break the uint8 == quantised-float identity of the service."""
    return images.float() / torch.full((), 255.0, device=images.device)


def make_normalizer(mean: np.ndarray, std: np.ndarray,
                    device: torch.device | str
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """uint8 (or float) images [..., 3] -> float32 `(x / 255 - mean) / std`
    (the /255 only for uint8), on `device`.  The same expression as the JAX
    normaliser; `normalize_per_record` divides too.  The `* (1.0 / std)`
    form belongs only to the services' `norm_ms` path."""
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device)

    def normalize(images: torch.Tensor) -> torch.Tensor:
        x = images.to(device)
        x = to_float01(x) if x.dtype == torch.uint8 else x.float()
        return (x - mean_t) / std_t

    return normalize


def normalize_per_record(images: torch.Tensor, mean: torch.Tensor,
                         std: torch.Tensor) -> torch.Tensor:
    """Each row of a multi-scene batch with its own scene's statistics:
    images [B, ...,  3], mean and std [B, 3] -> float32 `(x - m) / s`."""
    x = to_float01(images) if images.dtype == torch.uint8 else images.float()
    shape = (mean.shape[0],) + (1,) * (x.ndim - 2) + (3,)
    return (x - mean.reshape(shape)) / std.reshape(shape)


def batch_indices(rng: np.random.Generator, n: int, batch_size: int,
                  shuffle: bool, drop_remainder: bool = True
                  ) -> Iterator[np.ndarray]:
    order = rng.permutation(n) if shuffle else np.arange(n)
    end = n - (n % batch_size) if drop_remainder else n
    for i in range(0, end, batch_size):
        yield order[i:i + batch_size]


def data_iterator(dataset, batch_size: int, seed: int = 0,
                  shuffle: bool = True, epochs: int | None = 1,
                  drop_remainder: bool = True) -> Iterator[dict]:
    """Host-side batch iterator over a Packed/Concat dataset: raw numpy
    batches, epoch e shuffled by `default_rng(seed + e)`."""
    epoch = 0
    while epochs is None or epoch < epochs:
        rng = np.random.default_rng(seed + epoch)
        for idx in batch_indices(rng, len(dataset), batch_size, shuffle,
                                 drop_remainder):
            yield dataset.batch(idx)
        epoch += 1


def native_data_iterator(root: str, batch_size: int, seed: int = 0,
                         shuffle: bool = True, epochs: int | None = 1,
                         drop_remainder: bool = True,
                         threads: int = 4) -> Iterator[dict]:
    """`data_iterator` over one store, read by the native graphio runtime
    (mmap + thread-pool gather + async prefetch, `data/native_io.py`):
    the same batches in the same order.  Where the runtime does not build
    it reads the numpy memmaps."""
    from relpose_gnn_tpu_torch.data import native_io
    from relpose_gnn_tpu_torch.data.packed import PackedGraphDataset

    if not native_io.available():
        yield from data_iterator(PackedGraphDataset(root), batch_size,
                                 seed=seed, shuffle=shuffle, epochs=epochs,
                                 drop_remainder=drop_remainder)
        return
    loader = native_io.NativeBatchLoader(root, threads=threads)
    try:
        epoch = 0
        while epochs is None or epoch < epochs:
            rng = np.random.default_rng(seed + epoch)
            yield from loader.epoch(rng, batch_size, shuffle=shuffle,
                                    drop_remainder=drop_remainder)
            epoch += 1
    finally:
        loader.close()


def device_prefetch(host_iter: Iterator[dict], mean: np.ndarray,
                    std: np.ndarray, device: torch.device | str | None = None,
                    prefetch: int = 2) -> Iterator[dict]:
    """Batches of `host_iter` on `device` (None: the CUDA card), `images`
    normalised to float32 (per record where the batch carries
    `norm_mean` / `norm_std`, else with `mean` / `std`).

    A host thread gathers and pins; uploads and normalisation run on a
    side stream up to `prefetch` batches ahead.  An exception in the host
    iterator is raised here, after the batches before it."""
    device = resolve_device(device)
    normalize = make_normalizer(mean, std, device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    done = object()
    error: list[BaseException] = []

    def worker():
        try:
            for batch in host_iter:
                item = {k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in batch.items()}
                if cuda:
                    item = {k: v.pin_memory() for k, v in item.items()}
                q.put(item)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            error.append(exc)
        finally:
            q.put(done)

    def upload(item: dict):
        with torch.cuda.stream(side) if cuda else contextlib.nullcontext():
            out = {k: v.to(device, non_blocking=True)
                   for k, v in item.items()}
            if "norm_mean" in out:
                out["images"] = normalize_per_record(
                    out["images"], out.pop("norm_mean"), out.pop("norm_std"))
            else:
                out["images"] = normalize(out["images"])
            event = side.record_event() if cuda else None
        return out, event

    threading.Thread(target=worker, daemon=True).start()
    pending: collections.deque = collections.deque()
    exhausted = False
    while True:
        while not exhausted and len(pending) < prefetch:
            item = q.get()
            if item is done:
                exhausted = True
            else:
                pending.append(upload(item))
        if not pending:
            break
        out, event = pending.popleft()
        if cuda:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for v in out.values():
                v.record_stream(stream)
        yield out
    if error:
        raise error[0]
