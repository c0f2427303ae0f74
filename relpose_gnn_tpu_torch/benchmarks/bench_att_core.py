"""Microbenchmark: the attention-core kernel against its plain version.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_att_core [--e 16384] [--c 256]

Counterpart of the JAX package's `benchmarks/bench_att_pallas.py`.  At
`[E, C]` it first prints the kernel's relative max difference from the
plain core, then times both in float32 and in bfloat16, in turns (CUDA
events, median of `--iters`).  The plain core materialises the `[E, C, C]`
logits: 4 GiB per temporary at the default shape.

The helpers at the top are shared by the variant benches
(`bench_att_variants.py`, `bench_att_variants2.py`, `bench_att_exp2.py`),
which time each restructured form in turns with this kernel.

Runs on the CUDA card unless `--device cpu` asks otherwise (the plain
version then stands in for the kernel, which measures nothing of the card).
"""

from __future__ import annotations

import argparse
import sys

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _util
from relpose_gnn_tpu_torch.ops import att_core

# each restructured form must agree with the production kernel to this,
# relative to max |y| (the bar the JAX benches set)
REL_TOL = 1e-5
CHECK_ROWS = 256


def att_inputs(e: int, c: int, device: torch.device, seed: int = 0,
               scale: float = 1.0, dtype: torch.dtype = torch.float32):
    """phi, theta, g: [E, C] standard normal times `scale`, from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [(torch.randn(e, c, device=device, generator=gen) * scale
             ).to(dtype) for _ in range(3)]


def rel_max_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def add_common_args(ap: argparse.ArgumentParser, e: int) -> None:
    ap.add_argument("--e", type=int, default=e, help="rows (graph edges)")
    ap.add_argument("--c", type=int, default=256, help="channels")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")


def check_forms(forms: dict, args3, rows: int = CHECK_ROWS) -> dict:
    """Each form against the production kernel on the first `rows` rows;
    raises where one is off by `REL_TOL` or more.  Returns the relative
    max differences."""
    head = [a[:rows].contiguous() for a in args3]
    want = att_core.attention_core(*head)
    out = {}
    for name, fn in forms.items():
        rel = rel_max_diff(fn(*head), want)
        print(f"{name:12s} vs production kernel rel max diff: {rel:.2e}",
              flush=True)
        if not rel < REL_TOL:
            raise AssertionError(f"{name}: relative max difference {rel} "
                                 f"from the production kernel (>= {REL_TOL})")
        out[name] = rel
    return out


def time_forms(forms: dict, args3, iters: int, device: torch.device) -> dict:
    """The production kernel (`v0`) and every form, in turns; prints one
    line per form with its ratio to `v0`."""
    timed = {"v0": lambda: att_core.attention_core(*args3),
             **{n: (lambda fn=fn: fn(*args3)) for n, fn in forms.items()}}
    ms = _util.in_turns(timed, iters, device=device)
    print(f"v0 current  : {ms['v0']:8.3f} ms", flush=True)
    for name in forms:
        print(f"{name:12s}: {ms[name]:8.3f} ms  "
              f"({ms['v0'] / ms[name]:.2f}x)", flush=True)
    return ms


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap, e=16384)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    e, c = args.e, args.c

    before = att_core.LAUNCHES
    record = {"bench": "att_core", "e": e, "c": c, "iters": args.iters,
              **_util.device_record(device), "ms": {}, "rel_max_diff": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).removeprefix("torch.")
        a = att_inputs(e, c, device, dtype=dtype)
        rel = rel_max_diff(att_core.attention_core(*a),
                           att_core.attention_core_plain(*a))
        print(f"E={e} C={c} {name}  kernel vs plain rel max diff: "
              f"{rel:.2e}", flush=True)
        ms = _util.in_turns({
            "kernel": lambda: att_core.attention_core(*a),
            "plain": lambda: att_core.attention_core_plain(*a),
        }, args.iters, device=device)
        print(f"plain  {name:8s}: {ms['plain']:8.3f} ms", flush=True)
        print(f"kernel {name:8s}: {ms['kernel']:8.3f} ms  "
              f"({ms['plain'] / ms['kernel']:.2f}x)", flush=True)
        record["ms"][name] = ms
        record["rel_max_diff"][name] = rel
    record["launches"] = att_core.LAUNCHES - before
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
