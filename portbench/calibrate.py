"""Read what the correctness check's numbers give, to set their limits.

    python -m portbench.calibrate --workload <cell> --seeds 1 2 3 ... \
        [--seconds 3] [--control-seeds 7 8 9] [--faults half_batch ...] \
        [--fault-seeds 4 5 6] [--out FILE]

In one process, on the card: the program's runs of the cell (a short
window each; the lower readings), the control (the reference put in the
program's place, computed in float8: the upper readings) and the faults
of `faults.py` planted in the program.  One JSON line per run on standard
output (and appended to `--out`).  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np
import torch

from portbench import check_serve, check_train, faults, run as R, scenes
from portbench.drivers import serve_stream, train_loop
from portbench.reference import nets, pin_full_fp32


def control(run: R.Run) -> dict:
    """The numbers of the reference in float8, judged as the program."""
    fp8, fp32 = nets.Precision("fp8"), nets.Precision("float32")
    if run.traffic["driver"] == "train_loop":
        inp = train_loop._inputs(run)
        steps = run.traffic["check_steps"]
        prog = check_train.reference_steps(inp, fp8, steps)
        ref = check_train.reference_steps(inp, fp32, steps, prog["graphs"])
        return check_train.judge(ref, prog)
    inp = serve_stream._inputs(run)
    rng = np.random.default_rng(scenes.seed_of(run.seed, "check"))
    batches = sorted(rng.choice(200, size=run.traffic["check_batches"],
                                replace=False).tolist())
    answers = check_serve.serve(inp, batches, fp8)
    return check_serve.judge(inp, answers, run.limits["tie_margin"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=faults.NAMES)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = R.Cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    pin_full_fp32()
    dev = torch.device("cuda", 0)
    jobs = [("program", s, None) for s in args.seeds]
    jobs += [("control", s, None) for s in args.control_seeds]
    jobs += [(f, s, f) for f in args.faults for s in args.fault_seeds]
    for kind, seed, fault in jobs:
        run = R.Run(cell, seed, args.seconds, False, dev,
                    faults.Fault(fault) if fault else None)
        if kind == "control":
            rec = {"numbers": control(run)}
        else:
            rec = R.execute(run)
        line = {"cell": cell.name, "kind": kind, "seed": seed,
                "numbers": rec["numbers"],
                "metrics": rec.get("metrics"),
                "memory_peak_bytes": rec.get("memory_peak_bytes")}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del rec, run
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
