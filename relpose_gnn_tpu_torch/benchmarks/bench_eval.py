"""Headline benchmark: relocalization queries per second on one card.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_eval [--batch-size 128]

Counterpart of the JAX package's root `bench.py`.  Measures the flagship
eval path (RelPoseGNN 'R3': ResNet34 + dense edge-GNN on 8-node graphs,
dynamic kNN-4, absolute-pose recovery) as it is served: batched queries
with cached database-neighbour embeddings
(`evaluation/serving.py::make_cached_eval_step`), the BN-folded backbone
and the compact edge-list GNN, at 256x341 in bfloat16.

Before timing, the cached step is checked against the full pixel path on
one small batch (the same graphs with their neighbours encoded from
pixels): anchors equal, predictions within 0.1 where anchors agree (bf16
near-ties can flip an anchor; exact equality in float32 is held by the
tests).

Timing: CUDA events around each step, median of `--iters` after warm-up;
queries/s = batch / median.  `mfu` is the step's FLOPs, counted by
`torch.utils.flop_counter.FlopCounterMode` (matrix products and
convolutions; the hand-written attention kernel is not counted), over the
step's time and the H100's dense bf16 peak (989 TFLOP/s).

Prints ONE JSON line: {"metric", "value", "unit", "mfu", "step_ms",
"step_gflops", "peak_memory_gib", "model", "batch", "device", "card"}.
Runs on the CUDA card unless `--device cpu` asks otherwise (`mfu` and the
memory are null there).
"""

from __future__ import annotations

import argparse
import sys

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util
from relpose_gnn_tpu_torch.evaluation import serving

CHECK_BATCH = 2


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    _synthetic.add_model_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model, _ = _synthetic.models_from_args(args, device, with_netvlad=False)
    n, feat = model.cfg.num_nodes, model.cfg.feat_dim
    h, w, bsz = args.height, args.width, args.batch_size
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    step = serving.make_cached_eval_step(model)

    def inputs(b):
        return (torch.randn(b, h, w, 3, device=device, generator=gen),
                torch.randn(b, n - 1, 6, device=device, generator=gen),
                (~torch.eye(n, dtype=torch.bool, device=device)
                 ).expand(b, n, n))

    # self-check: cached neighbour embeddings against the pixel path
    q, poses, adj = inputs(CHECK_BATCH)
    nbr_pix = torch.randn(CHECK_BATCH, n - 1, h, w, 3, device=device,
                          generator=gen)
    cached = step(q, model.encode_nodes(nbr_pix), poses, adj)
    _, pred_rel, _, aux = model(torch.cat([q[:, None], nbr_pix], 1), adj)
    nbr = serving.graph_ops.nearest_neighbor(aux["node_feats"], node=0)
    rows = torch.arange(CHECK_BATCH, device=device)
    full = poses[rows, nbr - 1] - pred_rel[rows, nbr, 0]
    same = nbr == cached["nbr"]
    err = float((full - cached["pred"])[same].abs().max()) if same.any() \
        else 0.0
    if err >= 0.1:
        raise AssertionError(f"cached serving diverged from the pixel "
                             f"path: {err}")

    q, poses, adj = inputs(bsz)
    emb = torch.randn(bsz, n - 1, feat, device=device, generator=gen)

    def run():
        return step(q, emb, poses, adj)

    _util.reset_peak_memory(device)
    ms = _util.median_ms(run, args.iters, device=device)
    flops = _util.count_flops(run)
    record = {"metric": "relocalization queries/sec/chip",
              "value": bsz / ms * 1e3, "unit": "queries/s",
              "mfu": _util.mfu(flops, ms, device), "step_ms": ms,
              "step_gflops": flops / 1e9,
              "peak_memory_gib": _util.peak_memory_gib(device),
              "model": args.model_name, "batch": bsz, "dtype": args.dtype,
              "hw": [h, w], "self_check_max_err": err,
              **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
