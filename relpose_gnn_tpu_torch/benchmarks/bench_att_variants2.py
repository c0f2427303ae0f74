"""Probe: restructured attention-core kernels against the production one.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_att_variants2
    python -m relpose_gnn_tpu_torch.benchmarks.bench_att_variants2 --exact
    python -m relpose_gnn_tpu_torch.benchmarks.bench_att_variants2 --kernel v2

Counterpart of the JAX package's `benchmarks/bench_att_variants2.py`.
Three forms of the attention core, each a hand-written kernel of
`csrc/att_variants.cu` reached through
`ops/att_variants.py::restructured_core` on its default route:

  base  the row max scanned over j in a first pass, then the exp and sum
        pass: what the production TPU body does.
  v1    analytic max: m_i = max(phi_i * max(theta), phi_i * min(theta)),
        bit-exact against the scanned max (the row max of a rank-1 grid
        is attained at max or min theta, and phi_i * tmax is literally
        one of the grid's products, so rounding is identical).  Removes
        the first pass.  Its first kernel (`route="simple"`) was the
        production CUDA kernel's form until that kernel's redesign, and
        is what `chip_smoke.py` times the production kernel against.  The
        production kernel keeps the analytic max but builds the logit
        with one FMA in the exp2 domain, so it agrees with `v1` to 1e-5
        of max |y| and not bit for bit.
  v2    analytic max + j swept in chunks of 128 with (z, y) partial sums
        per chunk, added in chunk order: no rescaling is needed since m
        is known up front.  Two chunks are in flight at once, which
        breaks the serial accumulation chain of the one-pass loop.

`--exact` runs the tiny exactness check only (64 rows, inputs scaled by
3): mismatched bit patterns and max relative error of v1 and v2 against
base; v1 must show 0 mismatches.  Without it, every form (or the one named
by `--kernel`) is first held to 1e-5 of the production kernel on 256 rows
and then timed in turns with it.  One JSON line at the end.

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
    add_common_args, att_inputs, check_forms, rel_max_diff, time_forms)
from relpose_gnn_tpu_torch.ops import att_variants

EXACT_ROWS = 64


def exactness(c: int, device: torch.device) -> dict:
    """v1 and v2 against base on `EXACT_ROWS` rows of 3 * N(0, 1):
    {form: (mismatched bit patterns, max relative error)}; raises if v1
    is not bit-exact."""
    a = att_inputs(EXACT_ROWS, c, device, seed=1, scale=3.0)
    base = att_variants.restructured_core("base", *a)
    out = {}
    for name in ("v1", "v2"):
        got = att_variants.restructured_core(name, *a)
        bits = int((got.view(torch.int32) != base.view(torch.int32)).sum())
        err = rel_max_diff(got, base)
        print(f"{name}: mismatched bit-patterns {bits}/{got.numel()}, "
              f"max rel err vs base {err:.2e}", flush=True)
        out[name] = {"mismatched": bits, "rel_max_diff": err}
    if out["v1"]["mismatched"]:
        raise AssertionError("v1 (analytic max) is not bit-exact against "
                             f"base: {out['v1']}")
    return out


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, e=16384)
    ap.add_argument("--exact", action="store_true",
                    help="run the tiny exactness check only")
    ap.add_argument("--kernel", choices=tuple(
        att_variants.RESTRUCTURED_FORMS), help="time this form only")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    e, c = args.e, args.c

    names = [args.kernel] if args.kernel else list(
        att_variants.RESTRUCTURED_FORMS)
    keys = [f"restructured_core/{n}" for n in
            att_variants.RESTRUCTURED_FORMS]
    before = {k: att_variants.LAUNCHES[k] for k in keys}
    record = {"bench": "att_variants2", "e": e, "c": c,
              "iters": args.iters, **_util.device_record(device),
              "exact": exactness(c, device)}
    if not args.exact:
        a = att_inputs(e, c, device)
        forms = {n: functools.partial(att_variants.restructured_core, n)
                 for n in names}
        record["rel_max_diff"] = check_forms(forms, a)
        print(f"E={e} C={c}", flush=True)
        record["ms"] = time_forms(forms, a, args.iters, device)
    record["launches"] = {k: att_variants.LAUNCHES[k] - before[k]
                          for k in keys}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
