"""The space-to-depth serving stem against the 7x7/s2 stem, whole backbone.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_s2d [--batch 64]

Counterpart of the JAX package's `benchmarks/bench_s2d.py`.  Times the
whole BN-folded serving backbone (ResNet34, feat 2048, bf16, seeded
weights and BatchNorm statistics) at 256x341, once with the plain 7x7/s2
`conv1` and once with its space-to-depth form
(`models/fold_bn.py::fold_relpose_backbone(model, s2d_stem=True)`: 2x2
pixel blocks packed into 12 channels, a 4x4/s1 conv), the two in turns
(CUDA events, median of `--iters` after warm-up), and prints the largest
difference between the two stems' features (the same function up to the
order of float summation).

The FLOPs of a step are counted by `torch.utils.flop_counter.
FlopCounterMode`, which sees only convolutions and matrix products
(2 per multiply-add); the JAX script reads XLA's cost analysis, which
also counts elementwise work.  The s2d stem's count includes the zero
taps of its padded 8x8 kernel.

Prints one JSON line (and writes it to `--json PATH`).  Runs on the CUDA
card unless `--device cpu` asks otherwise.
"""

from __future__ import annotations

import argparse
import sys

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util
from relpose_gnn_tpu_torch.models.fold_bn import fold_relpose_backbone

STEMS = {"7x7": False, "s2d": True}


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=341)
    ap.add_argument("--backbone", default="resnet34")
    ap.add_argument("--dims", type=int, default=None,
                    help="override feat_dim, edge_dim and node_dim")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=tuple(_synthetic.DTYPES))
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--stem", default="both", choices=("7x7", "s2d", "both"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = _synthetic.DTYPES[args.dtype]
    dims = {} if args.dims is None else dict(
        feat_dim=args.dims, edge_dim=args.dims, node_dim=args.dims)
    model = _synthetic.unfolded_pose_model(
        device, "R3", dtype, args.seed, num_nodes=2, knn=0,
        backbone=args.backbone, **dims)
    b, h, w = args.batch, args.height, args.width
    gen = torch.Generator(device=device).manual_seed(args.seed + 2)
    x = torch.randn(b, h, w, 3, device=device, generator=gen)

    names = list(STEMS) if args.stem == "both" else [args.stem]
    steps, feats, flops = {}, {}, {}
    for name in names:
        _, enc = fold_relpose_backbone(model, s2d_stem=STEMS[name])

        def step(enc=enc):
            return enc.encode_nodes(x[:, None])[:, 0]

        steps[name] = step
        feats[name] = step()
        flops[name] = _util.count_flops(step)
    ms = _util.in_turns(steps, args.iters, args.warmup, device)

    stems = {}
    for name in names:
        stems[name] = {"ms": ms[name], "img_per_s": b / ms[name] * 1e3,
                       "flops_per_step": flops[name],
                       "eff_tflops": flops[name] / ms[name] / 1e9,
                       "bf16_peak_share": _util.mfu(flops[name], ms[name],
                                                    device)}
        print(f"{name}: {ms[name]:8.3f} ms/step  {b / ms[name] * 1e3:8.1f} "
              f"img/s  flops/step={flops[name]:.3e}  "
              f"eff_tflops={flops[name] / ms[name] / 1e9:.1f}", flush=True)
    record = {"batch": b, "hw": [h, w], "backbone": args.backbone,
              "dtype": args.dtype, "stems": stems, "iters": args.iters,
              **_util.device_record(device)}
    if len(names) == 2:
        diff = float((feats["s2d"] - feats["7x7"]).abs().max())
        scale = float(feats["7x7"].abs().max())
        record.update(s2d_speedup=ms["7x7"] / ms["s2d"],
                      max_feature_diff=diff, max_feature=scale)
        print(f"s2d speedup over 7x7 stem: {ms['7x7'] / ms['s2d']:.3f}x; "
              f"largest feature difference {diff:.3e} (max |feature| "
              f"{scale:.3e})", flush=True)
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
