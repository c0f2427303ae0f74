"""Probe: the 4x4-packed ("double space-to-depth") stem against the 7x7/s2.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_stem_s2d2 [--batch 512]

Counterpart of the JAX package's `benchmarks/bench_stem_s2d2.py`.  The
packed form pads the width to a multiple of 4, packs 4x4 pixel blocks
into 48 channels ([B, 64, 86, 48] at 256x341), runs one 3x3/s1
convolution to 256 = 2 x 2 x 64 channels, which produces all four output
phases of the 7x7/s2 stem (its kernel padded to 8x8) at once, and puts
them back in place (depth-to-space, [B, 128, 172, 64], cropped to
[B, 128, 171, 64]).  Its contraction is 3 x 3 x 48 = 432 taps against the
true 147, 2.25x the products, for a 4x wider output.  The probe times the
shape with random weights (the exact weight transform was never built),
followed by the same ReLU and 3x3/s2 max pool as the plain stem, and
times it in turns with the plain stem of `bench_backbone_stages` in the
same process (CUDA events, median of `--iters` after warm-up), at batch
512 in bf16 by default.  The effective rate of both is the true-tap
count, 2 x 128 x 171 x 147 x 64 a frame, over the time.

Prints one JSON line (and writes it to `--json PATH`).  Runs on the CUDA
card unless `--device cpu` asks otherwise.
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util
from relpose_gnn_tpu_torch.benchmarks.bench_backbone_stages import Stem
from relpose_gnn_tpu_torch.models.posenet import init_weights


def packed_stem(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """x [B, H, W, 3] NHWC (H % 4 == 0), w [256, 48, 3, 3] (torch's
    layout of the JAX function's HWIO [3, 3, 48, 256]), b [256] ->
    [B, H/2, ceil(W/2), 64] NHWC, in x's dtype."""
    bsz, h, w_in, c = x.shape
    pw = (-w_in) % 4
    if pw:
        x = F.pad(x, (0, 0, 0, pw))
    w4, h4 = (w_in + pw) // 4, h // 4
    # pack 4x4 pixel blocks into channels: [B, h4, w4, 48]
    x = x.reshape(bsz, h4, 4, w4, 4, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(bsz, h4, w4, 16 * c)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype),
                 padding=1).permute(0, 2, 3, 1)
    # depth-to-space: 256 = (2 phases in y) x (2 phases in x) x 64
    y = y.reshape(bsz, h4, w4, 2, 2, 64).permute(0, 1, 3, 2, 4, 5)
    y = y.reshape(bsz, h4 * 2, w4 * 2, 64)
    return y[:, : h // 2, : (w_in + 1) // 2, :]


def packed_stem_pooled(x, w, b) -> torch.Tensor:
    """`packed_stem`, ReLU, 3x3/s2 max pool: NCHW (channels-last) out,
    the plain stem's form."""
    y = F.relu(packed_stem(x, w, b)).permute(0, 3, 1, 2)
    return F.max_pool2d(y, 3, 2, 1)


def true_tap_flops(batch: int, h: int = 256, w: int = 341) -> int:
    """The 7x7/s2 stem's products (2 per multiply-add) at batch x h x w."""
    return 2 * (h // 2) * ((w + 1) // 2) * 147 * 64 * batch


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    dtype = _synthetic.DTYPES[args.dtype] or torch.float32
    bsz, h, w_in = args.batch, 256, 341
    gen = torch.Generator(device=device).manual_seed(args.seed)
    x0 = torch.randn(bsz, h, w_in, 3, device=device, generator=gen).to(dtype)
    wk = (torch.randn(256, 48, 3, 3, device=device, generator=gen)
          * 0.05).to(dtype)
    bk = (torch.randn(256, device=device, generator=gen) * 0.05).to(dtype)
    with torch.device(device):
        stem = Stem(dtype).eval()
    init_weights(stem, gen)

    y = packed_stem(x0[:2], wk, bk)
    if tuple(y.shape) != (2, 128, 171, 64):
        raise AssertionError(f"packed stem gave {tuple(y.shape)}")
    pooled = packed_stem_pooled(x0[:2], wk, bk)
    plain = stem(x0[:2])
    if pooled.shape != plain.shape:
        raise AssertionError(f"packed {tuple(pooled.shape)} against plain "
                             f"{tuple(plain.shape)}")
    ms = _util.in_turns({
        "packed": lambda: packed_stem_pooled(x0, wk, bk),
        "plain": lambda: stem(x0)}, args.iters, args.warmup, device)
    gf = true_tap_flops(bsz, h, w_in) / 1e9
    print(f"packed 4x4 stem: {ms['packed']:.3f} ms ({gf / ms['packed']:.1f} "
          f"effective TFLOP/s); plain 7x7 stem: {ms['plain']:.3f} ms "
          f"({gf / ms['plain']:.1f}); packed / plain "
          f"{ms['packed'] / ms['plain']:.3f} (true taps {gf:.1f} GFLOP)",
          flush=True)
    record = {"batch": bsz, "dtype": args.dtype, "hw": [h, w_in],
              "packed_ms": ms["packed"], "plain_ms": ms["plain"],
              "packed_over_plain": ms["packed"] / ms["plain"],
              "true_tap_gflop": gf,
              "packed_eff_tflops": gf / ms["packed"],
              "plain_eff_tflops": gf / ms["plain"],
              "iters": args.iters, **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
