"""Probe: exp against exp2 with a prescaled phi inside the attention kernel.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_att_exp2 [--e 16384] [--c 256]

Counterpart of the JAX package's `benchmarks/bench_att_exp2.py`.  The
attention core does E * C^2 exponentials per call.  `expf(x)` computes
`exp2(x * log2(e))`: one more multiply, and a range reduction, per
element of the logit grid.  Because the logits are rank-1 (f_ij = phi_i *
theta_j), that multiply can be hoisted: scale phi by log2(e) once per row
and call exp2 on the grid.  The row max computed from the scaled products
is the scaled max (log2(e) > 0), so the softmax is as stable as before.

The exp2 form is `ops/att_variants.py::exp2_core` (kernel in
`csrc/att_variants.cu`): the probe of the exp2 prescale alone, in the
layout of the first production kernel.  Beside it runs the production
kernel `ops/att_core.py::attention_core`, which has since taken the exp2
domain over together with a fused logit, raw `ex2.approx` and several
chains a thread (the exp form it once was is `restructured_core` 'v1'
on route "simple").  Correctness first, on 64 rows: both
kernels against the plain core and against each other, relative to
max |y|; the exp2 kernel must be within 1e-5.  Then the two are timed in
turns (CUDA events, median of `--iters` after warm-up).  One JSON line at
the end.

Runs on the CUDA card unless `--device cpu` asks otherwise (the plain
versions then stand in, which measures nothing of the card).
"""

from __future__ import annotations

import argparse
import sys

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _util
from relpose_gnn_tpu_torch.benchmarks.bench_att_core import (
    REL_TOL, add_common_args, att_inputs, time_forms)
from relpose_gnn_tpu_torch.ops import att_core, att_variants

CHECK_ROWS = 64


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, e=16384)   # serving batch 256
    ap.add_argument("--check-only", action="store_true",
                    help="the correctness check only, no timing")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    e, c = args.e, args.c
    before = att_variants.LAUNCHES["exp2_core"]

    # correctness first (tiny)
    small = att_inputs(CHECK_ROWS, c, device, seed=1)
    ref = att_core.attention_core_plain(*small)
    got_exp = att_core.attention_core(*small)
    got = att_variants.exp2_core(*small)
    scale = float(ref.abs().max())
    err_exp = float((got_exp - ref).abs().max()) / scale
    err = float((got - ref).abs().max()) / scale
    kk_err = float((got - got_exp).abs().max()) / scale
    print(f"rel err vs plain  production: {err_exp:.2e}  exp2: {err:.2e}  "
          f"kernel-vs-kernel: {kk_err:.2e}", flush=True)
    if not err < REL_TOL:
        raise AssertionError(f"exp2 kernel off the plain core by {err}")

    record = {"bench": "att_exp2", "e": e, "c": c, "iters": args.iters,
              **_util.device_record(device),
              "rel_err": {"exp": err_exp, "exp2": err,
                          "kernel_vs_kernel": kk_err}}
    if not args.check_only:
        a = att_inputs(e, c, device)
        print(f"E={e} C={c}", flush=True)
        ms = time_forms({"exp2": att_variants.exp2_core}, a, args.iters,
                        device)
        print(f"production: {ms['v0']:7.3f} ms   exp2(prescaled): "
              f"{ms['exp2']:7.3f} ms   ratio "
              f"{ms['v0'] / ms['exp2']:.3f}x", flush=True)
        record["ms"] = ms
    record["launches"] = {
        "exp2_core": att_variants.LAUNCHES["exp2_core"] - before}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
