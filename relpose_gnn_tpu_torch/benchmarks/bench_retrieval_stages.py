"""Per-stage probe of the retrieval trunk (VGG16 + NetVLAD + ranking).

    python -m relpose_gnn_tpu_torch.benchmarks.bench_retrieval_stages
    python -m relpose_gnn_tpu_torch.benchmarks.bench_retrieval_stages \
        --stage rank --db 4096 --rank-dtype bfloat16

Counterpart of the JAX package's `benchmarks/bench_retrieval_stages.py`.
Stages at `--retrieval-hw` (default 192x256; NHWC at the boundary, bf16):

    block1  [B, 192, 256, 3]   -> [B, 96, 128, 64]   (2 convs + pool)
    block2  [B, 96, 128, 64]   -> [B, 48, 64, 128]   (2 convs + pool)
    block3  [B, 48, 64, 128]   -> [B, 24, 32, 256]   (3 convs + pool)
    block4  [B, 24, 32, 256]   -> [B, 12, 16, 512]   (3 convs + pool)
    block5  [B, 12, 16, 512]   -> same               (3 convs, no pool)
    vlad    [B, 12, 16, 512]   -> [B, K * 512]       (assign + agg + norms)
    rank    [B, K * 512] x [M, K * 512] -> [B, M]    (the DB similarity,
            `evaluation/service.py::similarities`, then top-(k+1))

Each stage runs the layers of `models/vgg.py::VGG16Features` and
`models/netvlad.py::NetVLAD` themselves (seeded weights) on an input of
the stage's shape, alone: CUDA events, median of `--iters` after warm-up.
Every stage is timed in one call unless `--stage` names one.  The FLOP
count is the stage's convolutions and products (2 per multiply-add); the
share is of the H100's dense bf16 peak, 989 TFLOP/s.  `--rank-dtype
bfloat16` halves the table the rank product reads.

Prints one JSON line (and writes it to `--json PATH`).  Runs on the CUDA
card unless `--device cpu` asks otherwise.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn as nn
import torch.nn.functional as F

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util
from relpose_gnn_tpu_torch.evaluation.service import (_RANK_DTYPES,
                                                      similarities)

BLOCKS = ("block1", "block2", "block3", "block4", "block5")
STAGES = BLOCKS + ("vlad", "rank")


def vgg_blocks(encoder: nn.Sequential) -> list[list[nn.Module]]:
    """The trunk's layers cut after each max pool: five blocks."""
    blocks, cur = [], []
    for layer in encoder:
        cur.append(layer)
        if isinstance(layer, nn.MaxPool2d):
            blocks.append(cur)
            cur = []
    blocks.append(cur)
    return blocks


def run_block(layers, x: torch.Tensor) -> torch.Tensor:
    """NHWC in, NHWC out, as `VGG16Features.forward` runs its layers."""
    x = x.permute(0, 3, 1, 2)
    for layer in layers:
        if isinstance(layer, nn.Conv2d):
            x = F.conv2d(x, layer.weight.to(x.dtype),
                         layer.bias.to(x.dtype), padding=1)
        else:
            x = layer(x)
    return x.permute(0, 2, 3, 1)


def block_flops(layers, batch: int, h: int, w: int) -> int:
    total = 0
    for layer in layers:
        if isinstance(layer, nn.Conv2d):
            total += 2 * h * w * layer.in_channels * layer.out_channels * 9
        elif isinstance(layer, nn.MaxPool2d):
            h, w = h // 2, w // 2
    return batch * total


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", choices=STAGES + ("all",), default="all")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--db", type=int, default=4096,
                    help="rank stage: database rows M")
    ap.add_argument("--knn", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--retrieval-hw", type=int, nargs=2, default=(192, 256))
    ap.add_argument("--rank-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="rank stage: descriptor-table type")
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    _synthetic.add_model_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b = args.batch
    dtype = _synthetic.DTYPES[args.dtype]
    act = dtype or torch.float32
    want = STAGES if args.stage == "all" else (args.stage,)
    enc = _synthetic.netvlad_encoder(device, args.clusters, dtype,
                                     args.seed + 1)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    rows = {}

    def timed(name, fn, flops, note=""):
        ms = _util.median_ms(fn, args.iters, device=device)
        share = _util.mfu(flops, ms, device)
        rows[name] = {"ms": ms, "gflop": flops / 1e9,
                      "tflops": flops / ms / 1e9, "bf16_peak_share": share}
        print(f"{name:7s} {ms:8.3f} ms  {flops / 1e9:8.1f} GFLOP  "
              f"{flops / ms / 1e9:7.1f} TFLOP/s"
              + (f"  {share:.1%} of bf16 peak" if share is not None else "")
              + note, flush=True)

    h, w = args.retrieval_hw
    cin = 3
    for name, layers in zip(BLOCKS, vgg_blocks(enc.encoder)):
        if name in want:
            x = torch.randn(b, h, w, cin, device=device,
                            generator=gen).to(act)
            timed(name, lambda: run_block(layers, x),
                  block_flops(layers, b, h, w))
        cin = [m.out_channels for m in layers
               if isinstance(m, nn.Conv2d)][-1]
        if any(isinstance(m, nn.MaxPool2d) for m in layers):
            h, w = h // 2, w // 2

    k, c = enc.num_clusters, enc.encoder_dim
    if "vlad" in want:
        x = torch.randn(b, h, w, c, device=device, generator=gen).to(act)
        timed("vlad", lambda: enc.pool(x), b * 4 * h * w * c * k)
    if "rank" in want:
        # unit-norm rows, rounded once to the table's type as `_embed` does
        table = F.normalize(torch.randn(args.db, k * c, device=device,
                                        generator=gen), dim=-1).to(
            _RANK_DTYPES[args.rank_dtype])
        q = F.normalize(torch.randn(b, k * c, device=device, generator=gen),
                        dim=-1)
        table_mb = table.numel() * table.element_size() / 1e6

        def rank():
            return torch.topk(similarities(q, table),
                              min(args.knn + 1, args.db), dim=1)

        timed("rank", rank, b * 2 * args.db * k * c,
              f"  (table {table_mb:.0f} MB, {args.rank_dtype})")

    record = {"batch": b, "db": args.db, "dtype": args.dtype,
              "retrieval_hw": list(args.retrieval_hw),
              "rank_dtype": args.rank_dtype, "clusters": k,
              "stages": rows, **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
