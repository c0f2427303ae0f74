"""Per-stage roofline probe of the serving backbone (folded ResNet34).

    python -m relpose_gnn_tpu_torch.benchmarks.bench_backbone_stages
    python -m relpose_gnn_tpu_torch.benchmarks.bench_backbone_stages \
        --stage layer1 --batch 256

Counterpart of the JAX package's `benchmarks/bench_backbone_stages.py`.
Times each stage of the BN-folded ResNet34 alone at the serving shape
(256x341, bf16, batch 512 by default), to find which stage sits below the
card's peak.  The stages are built from the port's own folded
`BasicBlock` (`models/resnet.py`), seeded weights, and take the layout the
port's ResNet serves in: NCHW views of NHWC memory (channels-last
strides), so cuDNN runs every convolution in NHWC.

Stage shapes at 256x341 (NHWC, after the 7x7/s2 stem + 3x3/s2 max pool):

    stem    [B, 256, 341, 3]  -> [B, 64, 86, 64]
    layer1  [B, 64, 86, 64]   -> same             (3 blocks)
    layer2  [B, 64, 86, 64]   -> [B, 32, 43, 128] (4 blocks, s2 entry)
    layer3  [B, 32, 43, 128]  -> [B, 16, 22, 256] (6 blocks, s2 entry)
    layer4  [B, 16, 22, 256]  -> [B, 8, 11, 512]  (3 blocks, s2 entry)
    head    [B, 8, 11, 512]   -> [B, 2048]        (float32 mean + fc)

`stage_flops` is the JAX script's count (2 per multiply-add, the output
extent taken as the input's floor-divided by the stride, as it takes it).
The share is of the H100's dense bf16 peak, 989 TFLOP/s.  With `--stage
all` (the default) the six stages are timed in turns in one process
(CUDA events, median of `--iters` after warm-up, forwards then
backwards); the inputs are made on the device from `--seed`.

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
from relpose_gnn_tpu_torch.models.posenet import init_weights
from relpose_gnn_tpu_torch.models.resnet import BasicBlock, _conv

# input (H, W, C) per stage at 256x341, and each stage's blocks
STAGES = {
    "stem":   dict(shape=(256, 341, 3)),
    "layer1": dict(shape=(64, 86, 64),  blocks=3, filters=64,  stride=1),
    "layer2": dict(shape=(64, 86, 64),  blocks=4, filters=128, stride=2),
    "layer3": dict(shape=(32, 43, 128), blocks=6, filters=256, stride=2),
    "layer4": dict(shape=(16, 22, 256), blocks=3, filters=512, stride=2),
    "head":   dict(shape=(8, 11, 512)),
}
# output (H, W, C) per stage: each stage's input is the one before's output
OUT_SHAPES = {"stem": (64, 86, 64), "layer1": (64, 86, 64),
              "layer2": (32, 43, 128), "layer3": (16, 22, 256),
              "layer4": (8, 11, 512), "head": (2048,)}


class Stem(nn.Module):
    """The 7x7/s2 conv (folded: with a bias) + ReLU + 3x3/s2 max pool:
    NHWC [B, H, W, 3] -> NCHW (channels-last) [B, 64, H/4, W/4]."""

    def __init__(self, dtype: torch.dtype | None = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        return F.max_pool2d(F.relu(_conv(x, self.conv1)), 3, 2, 1)


class Stage(nn.Module):
    """`blocks` folded BasicBlocks, the first with `stride`."""

    def __init__(self, in_planes: int, blocks: int, filters: int,
                 stride: int):
        super().__init__()
        self.blocks = nn.Sequential(*[
            BasicBlock(in_planes if i == 0 else filters, filters,
                       stride if i == 0 else 1, folded=True)
            for i in range(blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class Head(nn.Module):
    """The mean over H and W in float32, then `fc` (512 -> 2048)."""

    def __init__(self, feat_dim: int = 2048):
        super().__init__()
        self.fc = nn.Linear(512, feat_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.mean(x.float(), dim=(2, 3))
        return F.linear(x, self.fc.weight, self.fc.bias)


def stage_module(name: str, dtype: torch.dtype | None = torch.bfloat16
                 ) -> nn.Module:
    if name == "stem":
        return Stem(dtype)
    if name == "head":
        return Head()
    s = STAGES[name]
    return Stage(s["shape"][2], s["blocks"], s["filters"], s["stride"])


def _conv_flops(h, w, cin, cout, k, stride):
    return 2 * (h // stride) * (w // stride) * cin * cout * k * k


def stage_flops(name: str, batch: int) -> int:
    """The JAX script's FLOP count of a stage at `batch`."""
    s = STAGES[name]
    h, w, c = s["shape"]
    if name == "stem":
        return batch * _conv_flops(h, w, 3, 64, 7, 2)
    if name == "head":
        return batch * 2 * 512 * 2048
    f = 0
    filters, stride = s["filters"], s["stride"]
    for i in range(s["blocks"]):
        st = stride if i == 0 else 1
        f += _conv_flops(h, w, c, filters, 3, st)                  # conv1
        f += _conv_flops(h // st, w // st, filters, filters, 3, 1)  # conv2
        if i == 0 and (c != filters or stride != 1):
            f += _conv_flops(h, w, c, filters, 1, stride)  # downsample
        h, w, c = h // st, w // st, filters
    return batch * f


def stage_input(name: str, batch: int, device: torch.device,
                dtype: torch.dtype | None, gen: torch.Generator
                ) -> torch.Tensor:
    """A unit-normal input of the stage's shape: NHWC for the stem, else
    the NCHW view of NHWC memory the stages run in."""
    h, w, c = STAGES[name]["shape"]
    x = torch.randn(batch, h, w, c, device=device, generator=gen)
    if dtype is not None:
        x = x.to(dtype)
    return x if name == "stem" else x.permute(0, 3, 1, 2)


def out_shape(name: str, y: torch.Tensor) -> tuple:
    """A stage's output shape in the NHWC terms of OUT_SHAPES."""
    if y.dim() == 2:
        return tuple(y.shape[1:])
    return (y.shape[2], y.shape[3], y.shape[1])


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stage", default="all", choices=("all", *STAGES))
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=tuple(_synthetic.DTYPES))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = _synthetic.DTYPES[args.dtype]
    names = list(STAGES) if args.stage == "all" else [args.stage]
    gen = torch.Generator(device=device).manual_seed(args.seed)

    forms, shapes = {}, {}
    for name in names:
        with torch.device(device):
            mod = stage_module(name, dtype).eval()
        init_weights(mod, gen)
        x = stage_input(name, args.batch, device, dtype, gen)
        y = mod(x)
        shapes[name] = out_shape(name, y)
        if shapes[name] != OUT_SHAPES[name]:
            raise AssertionError(f"{name}: output {shapes[name]} is not "
                                 f"{OUT_SHAPES[name]}")
        forms[name] = lambda mod=mod, x=x: mod(x)
    ms = _util.in_turns(forms, args.iters, args.warmup, device)

    stages = {}
    for name in names:
        flops = stage_flops(name, args.batch)
        stages[name] = {"ms": ms[name], "gflop": flops / 1e9,
                        "tflops": flops / ms[name] / 1e9,
                        "bf16_peak_share": _util.mfu(flops, ms[name],
                                                     device),
                        "in_shape": list(STAGES[name]["shape"]),
                        "out_shape": list(shapes[name])}
        share = stages[name]["bf16_peak_share"]
        print(f"{name:7s} {ms[name]:8.3f} ms  {flops / 1e9:8.1f} GFLOP  "
              f"{flops / ms[name] / 1e9:7.1f} TFLOP/s  "
              f"{'' if share is None else f'{100 * share:5.1f}% of peak'}",
              flush=True)
    record = {"batch": args.batch, "dtype": args.dtype, "stages": stages,
              "peak_bf16_tflops": _util.PEAK_BF16 / 1e12,
              "iters": args.iters, **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
