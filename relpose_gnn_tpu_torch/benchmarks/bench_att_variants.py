"""Attention-core variants: can the cost of the exponential be cut?

    python -m relpose_gnn_tpu_torch.benchmarks.bench_att_variants [--e 32768] [--c 256]
    python -m relpose_gnn_tpu_torch.benchmarks.bench_att_variants --check-only

Counterpart of the JAX package's `benchmarks/bench_att_variants.py`.  The
production attention kernel (`ops/att_core.py`) is bound by its E * C^2
exponentials and the float32 work around them.  Candidate rewrites, all
exact (the same function up to float32 rounding), each a hand-written
kernel of `csrc/att_variants.cu` reached through
`ops/att_variants.py::variant_core` on its default route (`route="simple"`
is the first kernel of each form, which `chip_smoke.py` times beside it):

  v1_exp2     : fold log2(e) into phi once per thread, so the per-logit
                exp(f - m) becomes a raw exp2(f2 - m2); `expf` is a
                multiply, `ex2.approx` and a range fix-up, so the hoist
                may remove work.
  v2_mxu      : the two sums over j (z and y) as one product
                w @ [g | 1] on the tensor cores (`mma.sync` m16n8k8, TF32
                halves of w and g, float32-accurate sums), freeing the FMA
                pipe of about 3 operations per logit.
  v3_exp2_mxu : both.

Protocol: each variant is first held to 1e-5 (relative to max |y|) of the
production kernel on 256 rows; then the production kernel and the variants
are timed in turns (CUDA events, median of `--iters` after warm-up, each
form's two medians averaged).  One JSON line at the end.

Runs on the CUDA card unless `--device cpu` asks otherwise (each form's
plain version then stands in, which measures nothing of the card).
"""

from __future__ import annotations

import argparse
import functools
import sys

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _util
from relpose_gnn_tpu_torch.benchmarks.bench_att_core import (
    add_common_args, att_inputs, check_forms, time_forms)
from relpose_gnn_tpu_torch.ops import att_variants


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, e=32768)   # serving batch 512
    ap.add_argument("--check-only", action="store_true",
                    help="the correctness check only, no timing")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    e, c = args.e, args.c

    a = att_inputs(e, c, device)
    forms = {name: functools.partial(att_variants.variant_core, name)
             for name in att_variants.VARIANT_FORMS}
    keys = [f"variant_core/{name}" for name in forms]
    before = {k: att_variants.LAUNCHES[k] for k in keys}

    record = {"bench": "att_variants", "e": e, "c": c, "iters": args.iters,
              **_util.device_record(device),
              "rel_max_diff": check_forms(forms, a)}
    if args.check_only:
        print("correctness OK", flush=True)
    else:
        print(f"E={e} C={c}", flush=True)
        record["ms"] = time_forms(forms, a, args.iters, device)
    record["launches"] = {k: att_variants.LAUNCHES[k] - before[k]
                          for k in keys}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
