"""Training-step time and MFU on one card.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_train --batches 8,16
    python -m relpose_gnn_tpu_torch.benchmarks.bench_train --batches 32 --remat
    python -m relpose_gnn_tpu_torch.benchmarks.bench_train --grad-accum 2

Counterpart of the JAX package's `benchmarks/bench_train.py`.  Times the
whole train step (`training/trainer.py::make_train_step`: training
forward, masked homoscedastic L1, backward, Adam) of a preset (default R3:
ResNet34 at 256x341, dims 2048, 8-node graphs, dense kNN-4, two GNN
passes, bf16) on random images, poses and a fully connected adjacency, for
each batch of the ladder.  Weights are random from `--seed`.

Per row: step ms (CUDA events around one step, median of `--iters` after
two warm-up steps; with `--grad-accum k` a step is one micro-batch, k of
them per optimizer update), graphs/s, `mfu` (the FLOPs of one train step
by `_util.count_flops`: matrix products and convolutions, forward and
backward, and the attention kernel's forward at 3·E·C² a call; over the
step's time and 989 TFLOP/s), peak device
memory, and the attention kernel's launches per step.  Prints ONE JSON
line, {"train": [rows...], ...}.  Runs on the card unless `--device cpu`
asks otherwise (`mfu` and memory are null there).
"""

from __future__ import annotations

import argparse
import sys

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.ops import att_core
from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                    create_train_state,
                                                    make_train_step)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="8,16",
                    help="comma list of batch sizes (graphs per step)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute the backbone in the backward "
                         "(torch.utils.checkpoint)")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches per optimizer update")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    _synthetic.add_model_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = RelPoseGNNConfig.preset(args.model_name, dtype=_synthetic.DTYPES[
        args.dtype], remat=args.remat, **_synthetic.model_overrides(args))
    tcfg = TrainerConfig(steps_per_epoch=100, grad_accum=args.grad_accum)
    n, h, w = cfg.num_nodes, args.height, args.width
    train_step = make_train_step(tcfg)

    rows = []
    for bsz in (int(b) for b in args.batches.split(",")):
        gen = torch.Generator(device=device).manual_seed(args.seed + bsz)
        with torch.device(device):
            model = RelPoseGNN(cfg)
        init_weights(model, gen)
        state = create_train_state(model, tcfg)
        batch = {"images": torch.randn(bsz, n, h, w, 3, device=device,
                                       generator=gen),
                 "poses": torch.randn(bsz, n, 6, device=device,
                                      generator=gen),
                 "adj": (~torch.eye(n, dtype=torch.bool, device=device)
                         ).expand(bsz, n, n).contiguous()}

        def step():
            return train_step(state, batch, args.seed)

        _util.reset_peak_memory(device)
        for _ in range(2):
            step()
        att_core.LAUNCHES = 0
        ms = _util.median_ms(step, args.iters, warmup=0, device=device)
        launches = att_core.LAUNCHES / args.iters
        flops = _util.count_flops(step)
        loss = float(step()["loss"])
        row = {"batch": bsz, "remat": args.remat,
               "grad_accum": args.grad_accum, "ms_per_step": ms,
               "graphs_per_s": bsz / ms * 1e3, "flops_per_step": flops,
               "mfu": _util.mfu(flops, ms, device),
               "peak_memory_gib": _util.peak_memory_gib(device),
               "attention_launches_per_step": launches,
               "loss_finite": bool(torch.isfinite(torch.tensor(loss)))}
        rows.append(row)
        print(f"B={bsz}: {ms:.2f} ms/step, {row['graphs_per_s']:.1f} "
              f"graphs/s, mfu {row['mfu']}, peak {row['peak_memory_gib']} "
              f"GiB, attention launches/step {launches}", flush=True)
        del state, model, batch
    record = {"train": rows, "model": args.model_name, "dtype": args.dtype,
              "hw": [h, w], **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
