"""Training-feed bench: shuffled-batch assembly by the numpy memmaps, the
native graphio runtime and the store held on the card.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_feed

Counterpart of the JAX package's `benchmarks/bench_feed.py`, with a third
leg.  Writes two packed stores of `--graphs` graphs each at R3's graph
shape (8 nodes at 256x341, uint8) and times the assembly of `--batches`
shuffled two-store batches of `--batch` graphs:
  * `numpy`: `ConcatPackedDataset.batch` (memmap fancy indexing), host
    clock, no upload;
  * `native`: `native_io.NativeConcatDataset.batch` at 1, 2 and 4
    gather threads, host clock, no upload;
  * `cached`: `DeviceCachedFeed` over the same stores, one batch gathered
    and normalised on the device per call (CUDA events on a card, the
    median).
Rates are batches/s and GB/s of uint8 image bytes assembled (a batch is
`batch x nodes x H x W x 3` bytes, whatever else a leg writes).  Prints
ONE JSON line; runs on the card unless `--device cpu` asks otherwise
(the two host legs run on the host either way).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _util
from relpose_gnn_tpu_torch.data import native_io
from relpose_gnn_tpu_torch.data.device_cache import DeviceCachedFeed
from relpose_gnn_tpu_torch.data.packed import (ConcatPackedDataset,
                                               PackedGraphDataset,
                                               PackedGraphWriter)


def make_store(root: str, n: int, nodes: int, h: int, w: int,
               seed: int) -> str:
    """A store of n graphs of seeded uint8 noise (every byte differs from
    store to store and graph to graph)."""
    rng = np.random.default_rng(seed)
    wtr = PackedGraphWriter(root, num_graphs=n, num_nodes=nodes, height=h,
                            width=w, mean=[0.5] * 3, std=[0.25] * 3)
    adj = ~np.eye(nodes, dtype=bool)
    for i in range(n):
        img = rng.integers(0, 256, (nodes, h, w, 3), np.uint8)
        wtr.add(img.astype(np.float32) / 255.0,
                np.full((nodes, 6), i, np.float32), adj)
    wtr.finalize()
    return root


def host_rate(ds, batch_size: int, n_batches: int, seed: int) -> float:
    """Batches/s of `ds.batch` over shuffled batches, host clock, after
    one warm-up batch."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(ds))
    ds.batch(order[:batch_size])
    done = 0
    t0 = time.perf_counter()
    while done < n_batches:
        for i in range(0, len(ds) - batch_size + 1, batch_size):
            ds.batch(order[i:i + batch_size])
            done += 1
            if done >= n_batches:
                break
        order = rng.permutation(len(ds))
    return n_batches / (time.perf_counter() - t0)


STORES, THREADS, SEED = 2, (1, 2, 4), 0


def cached_ms(feed: DeviceCachedFeed, batch_size: int, iters: int,
              seed: int, device: torch.device) -> float:
    """Median ms of one batch of `feed.epoch` (gather + normalise)."""
    state = {"it": iter(())}

    def one():
        batch = next(state["it"], None)
        if batch is None:
            state["it"] = feed.epoch(seed=seed, batch_size=batch_size)
            batch = next(state["it"])
        return batch

    return _util.median_ms(one, iters, warmup=3, device=device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", type=int, default=48,
                    help="graphs per store")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=341)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--batches", type=int, default=40,
                    help="batches timed per leg")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gb = args.batch * args.nodes * args.height * args.width * 3 / 1e9

    def rates(per_s: float) -> dict:
        return {"batches_per_s": per_s, "gb_per_s": per_s * gb}

    with tempfile.TemporaryDirectory() as tmp:
        roots = [make_store(f"{tmp}/s{j}", args.graphs, args.nodes,
                            args.height, args.width, SEED + j)
                 for j in range(STORES)]
        cat = ConcatPackedDataset([PackedGraphDataset(r) for r in roots])
        numpy_leg = rates(host_rate(cat, args.batch, args.batches, SEED))
        print(f"numpy memmap: {numpy_leg['batches_per_s']:.1f} batches/s "
              f"({numpy_leg['gb_per_s']:.2f} GB/s)", flush=True)
        native_leg = []
        if native_io.available():
            nat = native_io.NativeConcatDataset(roots)
            try:
                for t in THREADS:
                    nat.threads = t
                    row = {"threads": t, **rates(host_rate(
                        nat, args.batch, args.batches, SEED))}
                    row["x_numpy"] = (row["batches_per_s"]
                                      / numpy_leg["batches_per_s"])
                    native_leg.append(row)
                    print(f"native t={t}: {row['batches_per_s']:.1f} "
                          f"batches/s ({row['gb_per_s']:.2f} GB/s, "
                          f"{row['x_numpy']:.2f}x numpy)", flush=True)
            finally:
                nat.close()
        else:
            print("native graphio does not build here", flush=True)
        t0 = time.perf_counter()
        feed = DeviceCachedFeed(cat, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        upload_s = time.perf_counter() - t0
        ms = cached_ms(feed, args.batch, args.batches, SEED, device)
        cached_leg = {"ms_per_batch": ms, **rates(1e3 / ms),
                      "nbytes": feed.nbytes, "upload_s": upload_s}
        print(f"device cache: {ms:.4f} ms/batch "
              f"({cached_leg['gb_per_s']:.2f} GB/s), store "
              f"{feed.nbytes / 1e9:.3f} GB uploaded in {upload_s:.3f} s",
              flush=True)
        del feed
    record = {"feed": {"numpy": numpy_leg, "native": native_leg,
                       "cached": cached_leg},
              "batch": args.batch, "stores": STORES,
              "graphs_per_store": args.graphs,
              "graph_shape": [args.nodes, args.height, args.width, 3],
              **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
