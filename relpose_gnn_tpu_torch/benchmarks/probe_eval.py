"""Probe: the eval step of the full R3 model from pixels.

    python -m relpose_gnn_tpu_torch.benchmarks.probe_eval [--batches 8,32]

Counterpart of the JAX package's `benchmarks/probe_eval.py`.  R3 (ResNet34
with BatchNorm in eval mode, dims 2048, the dynamic kNN-4 graph, two GNN
passes; seeded weights) in bf16 over batches of 8-node graphs whose every
node is encoded from pixels at 256x341, then the query's
`nearest_neighbor` in pre-GNN feature space and the anchor's recovery
`poses[nbr] - pred_rel[nbr, query]`: what `cli.test` computes per batch
of graphs.  For each batch size in `--batches` (8 and 32): CUDA events
around each call, median of `--iters` after warm-up; ms a batch and
queries/s.  The attention kernel runs twice a call (two GNN passes);
`attention_launches` counts it.

Prints one JSON line (and writes it to `--json PATH`).  Runs on the CUDA
card unless `--device cpu` asks otherwise.
"""

from __future__ import annotations

import argparse
import sys

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util, bench_eval
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.ops import att_core


def eval_fn(model: RelPoseGNN, images: torch.Tensor, adj: torch.Tensor,
            poses: torch.Tensor) -> torch.Tensor:
    """images [B, N, H, W, 3], adj [B, N, N], poses [B, N, 6] ->
    the recovered query poses [B, 6] (`bench_eval.reference_program`)."""
    return bench_eval.reference_program(model, images, adj, poses)[0]


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8,32",
                    help="comma list of batch sizes (graphs a call)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    _synthetic.add_model_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = RelPoseGNNConfig.preset(
        args.model_name, dtype=_synthetic.DTYPES[args.dtype],
        **_synthetic.model_overrides(args))
    with torch.device(device):
        model = RelPoseGNN(cfg).eval()
    init_weights(model, torch.Generator(device=device).manual_seed(
        args.seed))
    n, h, w = cfg.num_nodes, args.height, args.width

    rows = {}
    launches = {}
    for batch in (int(s) for s in args.batches.split(",")):
        gen = torch.Generator(device=device).manual_seed(args.seed + batch)
        images = torch.randn(batch, n, h, w, 3, device=device, generator=gen)
        poses = torch.randn(batch, n, 6, device=device, generator=gen)
        adj = (~torch.eye(n, dtype=torch.bool, device=device)).expand(
            batch, n, n)
        before = att_core.LAUNCHES
        ms = _util.median_ms(lambda: eval_fn(model, images, adj, poses),
                             args.iters, args.warmup, device)
        launches[str(batch)] = att_core.LAUNCHES - before
        rows[str(batch)] = {"ms": ms, "qps": batch / ms * 1e3}
        print(f"B={batch}: {ms:.3f} ms/batch  {batch / ms * 1e3:.1f} q/s",
              flush=True)
    record = {"model": args.model_name, "dtype": args.dtype, "hw": [h, w],
              "nodes": n, "batches": rows, "iters": args.iters,
              "warmup": args.warmup, "attention_launches": launches,
              **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
