"""Microbenchmark: what each step of the pair-MLP kernel's design buys.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_pair_mlp_steps
    python -m relpose_gnn_tpu_torch.benchmarks.bench_pair_mlp_steps --nodes 8

The bfloat16 'wgmma' route of `csrc/pair_mlp.cu` is built several times,
each build with one design step taken back by a preprocessor setting, and
all builds are timed in turns with the default build and with the
'mma_sync' route (the kernel the 'wgmma' route replaced at these shapes)
on the same inputs:

  default     the kernel as `ops/pair_mlp.py` launches it
  ring2       the ring of stages two deep instead of six (hidden tile 128)
              or four (hidden tile 256)
  ring43      four and three deep: what fits when the output chunks are
              staged behind the ring instead of in its idle A tiles
  tile128     hidden tile always 128 columns (16 partial sums per output
              at H = 2048 instead of 8)
  tile256     hidden tile always 256 columns (half as many blocks)
  rows_fast   the row tile always the fast grid index
  hidden_fast the hidden tile always the fast grid index (the default
              build takes it for grids deeper than one wave of blocks, and
              the row tile otherwise)
  atomics     partial sums added by one atomicAdd per float instead of the
              bulk reduce-add from a staged tile
  gather      operand tiles gathered by the producer's threads (cp.async,
              16 bytes each) instead of copied by TMA through tensor maps
              that broadcast the node table along a zero stride
  mma_sync    the mma.sync kernel: 64-row blocks, cp.async double buffer,
              two barriers per K step, scalar atomics

Every build is first held to the plain version (2e-3 of max |out|, the
bound `chip_smoke.py` derives).  Timing: CUDA events around each call,
median of `--iters` after warm-up, forwards then backwards.  One JSON line
at the end.  Needs the CUDA card and `nvcc`: a design step is a build of
the kernel, so there is no CPU form of this bench.
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _util
from relpose_gnn_tpu_torch.ops import _build, pair_mlp

# build name -> preprocessor settings of csrc/pair_mlp.cu
STEPS = {
    "default": (),
    "ring2": ("PAIR_STAGES_128=2", "PAIR_STAGES_256=2"),
    "ring43": ("PAIR_STAGES_128=4", "PAIR_STAGES_256=3"),
    "tile128": ("PAIR_FORCE_BH=128",),
    "tile256": ("PAIR_FORCE_BH=256",),
    "rows_fast": ("PAIR_RASTER_ROWS_FAST=1",),
    "hidden_fast": ("PAIR_RASTER_ROWS_FAST=0",),
    "atomics": ("PAIR_SCALAR_ATOMICS=1",),
    "gather": ("PAIR_GATHER_ALWAYS=1",),
}
REL_TOL = 2e-3


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=32)
    ap.add_argument("--dims", type=int, default=2048)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(None)
    if device.type != "cuda":
        raise RuntimeError("bench_pair_mlp_steps builds and times CUDA "
                           "kernels; it needs the CUDA card")
    b, n, d = args.batch, args.nodes, args.dims
    gen = torch.Generator(device=device).manual_seed(0)

    def r(*shape, scale=1.0):
        return (torch.randn(*shape, device=device, generator=gen)
                * scale).to(torch.bfloat16)

    x = r(b * n, d)
    fc1 = r(3 * d, d, scale=(3 * d) ** -0.5)
    ops = (x, x, r(b * n * n, d), fc1[:d], fc1[d:2 * d], fc1[2 * d:],
           torch.zeros(d, device=device), r(d, d, scale=d ** -0.5),
           torch.zeros(d, device=device), n)

    with ThreadPoolExecutor(len(STEPS)) as pool:      # one nvcc per build
        list(pool.map(lambda defs: _build.build("pair_mlp", defs),
                      STEPS.values()))
    forms = {name: (lambda defs=defs: pair_mlp._run_kernel(
        pair_mlp._lib(defs), "wgmma", *ops)) for name, defs in STEPS.items()}
    forms["mma_sync"] = lambda: pair_mlp._run_kernel(
        pair_mlp._lib(), "mma_sync", *ops)

    want = pair_mlp.fused_pair_mlp_plain(*ops)
    scale = float(want.abs().max())
    errs = {}
    for name, fn in forms.items():
        errs[name] = float((fn() - want).abs().max()) / scale
        if not errs[name] < REL_TOL:
            raise AssertionError(f"build {name} is off the plain version "
                                 f"by {errs[name]} of max |out|")
    ms = _util.in_turns(forms, args.iters, 3, device)
    rows = b * n * n
    flops = 2 * rows * d * (3 * d + d)
    for name, t in ms.items():
        print(f"{name:10s} {t:8.4f} ms  {flops / t / 1e9:7.1f} TFLOP/s  "
              f"{t / ms['default']:.3f}x default  (rel err {errs[name]:.2e})",
              flush=True)
    record = {"bench": "pair_mlp_steps", "e": rows, "dims": d,
              "iters": args.iters, **_util.device_record(device),
              "ms": ms, "rel_err": errs, "flops": flops}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
