"""The harness's plumbing on the CPU: cells found by name from data files
alone, readers that find nothing read null, the traced stretch's budget,
no fall-back to the CPU, and the check failing the control and each
fault while passing a sound run.  Runs on the CPU use tiny cells (see
conftest.py) and call the harness past its look for a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import calibrate, faults, run as R
from portbench.trace import Trace, Tracer
from portbench.tests import conftest as C

NETVLAD = {"num_clusters": 8, "encoder_dim": 512, "retrieval_hw": [48, 64],
           "dtype": "float32"}


def _cells():
    m = dict(C.TINY_MODEL, preset="R3")
    return {"tiny-serve": ({"model": m, "retrieval": NETVLAD},
                           C.TINY_SERVE, C.SERVE_LIMITS),
            "tiny-train": ({"model": m}, C.TINY_TRAIN, C.TRAIN_LIMITS)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench"))
    C.write_root(path, _cells())
    return path


def _run(root, cell, trace=False, fault=None, seed=2 ** 31 + 9,
         seconds=0.5):
    run = R.Run(R.Cell(cell, root), seed, seconds, trace, "cpu",
                faults.Fault(fault) if fault else None)
    rec = R.execute(run)
    out, lines = R.result_line(run, rec, trace)
    return out, lines


def test_a_cell_of_new_data_files_is_found_by_name(root):
    """A cell, a configuration, a traffic mix and limits that exist only
    as new files and new entries run with no edit of the harness."""
    cell = R.Cell("tiny-serve", root)
    assert cell.traffic["driver"] == "serve_stream"
    assert cell.config["model"]["feat_dim"] == 32
    assert {m["name"] for m in cell.end_to_end()} == {
        "query_throughput", "request_p95_ms", "setup_s"}
    out, lines = _run(root, "tiny-serve")
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device", "checks"}
    assert list(out)[-1] == "checks"
    assert out["correct"] is True
    assert set(out["metrics"]) == {"query_throughput", "request_p95_ms",
                                   "setup_s"}
    assert lines[-1].startswith("check ")


def test_the_serve_p95_is_read_per_layer_as_measured(root):
    """The serve driver hands the readers the same 95th percentile that it
    reports end to end; a run without it reads None."""
    run = R.Run(R.Cell("tiny-serve", root), 2 ** 31 + 11, 0.5, False,
                "cpu")
    rec = R.execute(run)
    p95 = rec["metrics"]["request_p95_ms"]
    assert p95 > 0
    assert R.read_metric("request_p95_ms.serve", rec["layer"]) == p95
    assert R.read_metric("request_p95_ms.serve", {}) is None


def test_a_new_metric_reader_is_found_by_name(root, tmp_path):
    path = os.path.join(root, "portbench", "metrics", "launches.test.py")
    with open(path, "w") as f:
        f.write("def read(ctx):\n    return 7.0\n")
    try:
        assert R.read_metric("launches.test", {}, root) == 7.0
    finally:
        os.remove(path)


def _events(kernels, launches, ranges):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": d,
           "args": {"correlation": c}} for n, s, d, c in kernels]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": s, "dur": 1, "args": {"correlation": c}}
           for s, c in launches]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
            "dur": d} for n, s, d in ranges]
    return ev


def test_readers_read_null_where_the_hook_point_is_missing():
    """A range that the stretch does not hold (its module or hook point is
    gone) reads None and the metric is left out, never 0."""
    tr = Trace(_events([("att_core_kernel<bf16>", 100, 50, 1),
                        ("conv", 160, 40, 2)],
                       [(10, 1), (20, 2)],
                       [("portbench.encode", 15, 10)]))
    ctx = {"trace": tr, "config": {"model": {"node_dim": 2048}},
           "edges_per_batch": 4096, "att_core_in_bytes": 2}
    assert R.read_metric("encode_ms.serve", ctx) == pytest.approx(0.04)
    assert R.read_metric("retrieval_trunk_ms.serve", ctx) is None
    assert R.read_metric("optimizer_ms.train", ctx) is None
    share = R.read_metric("att_core_roofline.serve", ctx)
    assert 0 < share < 100
    assert R.read_metric("idle_share.serve", ctx) == pytest.approx(
        100 * (1 - 90 / 190))
    empty = {"trace": Trace(_events([], [], [])), "config": ctx["config"]}
    for name in ("encode_ms.serve", "att_core_roofline.serve",
                 "idle_share.serve", "mfu.serve"):
        assert R.read_metric(name, empty) is None


def test_traced_stretch_stays_under_the_profiler_budget():
    """Every traffic mix's stretch records at most half of the ~50,000
    launches after which torch's profiler stops recording, and the tracer
    records exactly its `active` steps."""
    tdir = os.path.join(C.ROOT, "portbench", "traffic")
    for name in os.listdir(tdir):
        with open(os.path.join(tdir, name)) as f:
            tr = json.load(f)["trace"]
        assert tr["active"] * tr["launches_per_step"] < 50_000 / 2, name
    tracer = Tracer(True, 2, 3)
    lin = torch.nn.Linear(8, 8)
    assert tracer.hook_module(lin, "lin")
    assert not tracer.hook_module(None, "gone")
    with tracer:
        for _ in range(9):
            lin(torch.zeros(2, 8))
            tracer.step()
    assert tracer.steps_recorded == 3
    got = tracer.trace.range_device_s("lin")
    assert got is not None and got[1] == 3


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=C.ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "portbench", "--workload", "r3-serve-netvlad",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=C.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("fault", ["half_batch", "altered"])
def test_serve_check_fails_a_broken_service(root, fault):
    out, _ = _run(root, "tiny-serve", fault=fault)
    assert out["correct"] is False


@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_train_check_fails_a_broken_step(root, fault):
    out, _ = _run(root, "tiny-train", fault=fault)
    assert out["correct"] is False


def test_train_check_passes_a_sound_step(root):
    out, _ = _run(root, "tiny-train")
    assert out["correct"] is True
    assert out["metrics"]["train_throughput"]["value"] > 0


@pytest.mark.parametrize("cell", ["tiny-serve", "tiny-train"])
def test_the_control_comes_out_not_correct(root, cell):
    """The reference computed in float8, put in the program's place."""
    run = R.Run(R.Cell(cell, root), 12345, 0.5, False, "cpu")
    ok, checks = R.judge(calibrate.control(run), run.limits, 0)
    assert not ok, checks
