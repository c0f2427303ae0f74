"""Run one cell of the benchmark once.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic are found by name:
`BENCHMARK.json` names the cell's configuration file and traffic mix; the
mix `portbench/traffic/<traffic>.json` names its driver
`portbench/drivers/<driver>.py`; the cell's limits are
`portbench/limits/<cell>.json`; a per-layer metric is read by
`portbench/metrics/<metric>.py`; a configuration's node encoder is
`portbench/reference/encoders/<backbone>.py` (its reference forward, its
parameters and their initial kinds, the program's module that holds it),
and the fields of the configuration's `model.program` section reach the
program as they stand.  A new cell, configuration, encoder, mix or metric
is a new file and a new entry, and no edit.

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device`, with
`--trace 1` a `breakdown`, and last `checks`: each number the correctness
check compared, beside its limit (also the last lines of standard error).

Exits non-zero and prints no result where torch sees no CUDA device or
fewer than the cell asks for, and where a module of JAX or of the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "relpose_gnn_tpu")


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic and limits,
    all found by name under `root`."""

    def __init__(self, name: str, root: str = ROOT):
        self.root = root
        bench = _load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name, self.entry, self.bench = name, cells[name], bench
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = _load_json(os.path.join(
            root, configs[self.entry["config"]]["file"]))
        self.traffic = _load_json(os.path.join(
            root, "portbench", "traffic", self.entry["traffic"] + ".json"))
        self.limits = _load_json(os.path.join(root, "portbench", "limits",
                                              name + ".json"))

    def _mine(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"] if self._mine(m)]

    def per_layer(self) -> list:
        return [m for m in self.bench["per_layer"] if self._mine(m)]


class Run:
    """One run of a cell: what a driver reads and the hooks it calls."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, fault=None):
        from portbench.trace import Tracer
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.config, self.traffic = cell.config, cell.traffic
        self.limits, self.device, self.fault = cell.limits, device, fault
        tr = cell.traffic["trace"]
        self.tracer = Tracer(trace, tr["wait"], tr["active"])
        self.setup_s = None

    def sync(self) -> None:
        import torch
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        """The device allocator's peak so far in this process (0 off the
        card)."""
        import torch
        if torch.device(self.device).type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.device)

    def setup_done(self) -> float:
        """Marks the end of set-up (called by the driver just before its
        window): seconds since the process started."""
        self.setup_s = time.perf_counter() - T0
        return self.setup_s


def judge(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number named in
    `limits["max"]` at or under its limit, and nothing failed."""
    checks, ok = {}, failed == 0
    for name, limit in limits["max"].items():
        v = numbers.get(name, float("inf"))
        # a number that is not finite is out of every limit; JSON has no
        # infinity, so it is written as the largest double
        v = float(v) if math.isfinite(v) else 1.7976931348623157e308
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v <= limit
    return ok, checks


def read_metric(name: str, ctx: dict, root: str = ROOT):
    """The value of per-layer metric `name` from its reader
    `portbench/metrics/<name>.py`, or None where it finds nothing to
    read."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def execute(run: Run) -> dict:
    """Drive the cell's window and check; returns the driver's record."""
    driver = importlib.import_module(
        "portbench.drivers." + run.traffic["driver"])
    return driver.run(run)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def result_line(run: Run, rec: dict, trace: bool) -> tuple[dict, list]:
    """The result object and the lines naming each compared number."""
    import torch
    cell = run.cell
    ok, checks = judge(rec["numbers"], run.limits, rec["failed"])
    dev = torch.device(run.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell.entry["chips"],
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = {"correct": bool(ok), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"])}
    metrics = {}
    if trace:
        tr = rec["layer"]["trace"]
        ctx = dict(rec["layer"], config=run.config, traffic=run.traffic)
        for m in cell.per_layer():
            v = read_metric(m["name"], ctx, cell.root)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr is not None:
            rec["numbers"].update(trace_kernels=len(tr.kernels()))
            device["busy_s"] = tr.busy_s()
            device["window_s"] = tr.window_s
            ops = sorted(tr.device_ops_by_name().items(),
                         key=lambda kv: -kv[1])[:10]
            out["breakdown"] = {"device_ops": [[n[:160], s] for n, s in ops],
                                "idle_gaps": [[n[:160], s] for n, s in
                                              tr.idle_gaps(10)]}
    else:
        values = dict(rec["metrics"], setup_s=rec["setup_s"])
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    out["metrics"], out["device"] = metrics, device
    out["checks"] = checks
    lines = ["readings beside the checks: " + ", ".join(
        f"{k} {v!r}" for k, v in rec["numbers"].items() if k not in checks),
             f"correct: {ok} (failed {rec['failed']})"]
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
              for k, c in checks.items()]
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    cache = os.path.join(ROOT, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from portbench.reference import pin_full_fp32
    if not torch.cuda.is_available():
        print("portbench: torch sees no CUDA device; nothing measured",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: the cell needs {cell.entry['chips']} devices, "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    pin_full_fp32()
    run = Run(cell, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0))
    rec = execute(run)
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 4
    tr = rec["layer"]["trace"]
    if args.trace and (tr is None or not tr.kernels()):
        print("portbench: the traced window recorded no kernel (too few "
              "steps in the window for the traffic's trace schedule?)",
              file=sys.stderr)
        return 5
    out, lines = result_line(run, rec, bool(args.trace))
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
