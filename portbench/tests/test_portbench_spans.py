"""The readers of the program's spans (`portbench/spans.py` and the
metrics that use it) on synthetic Chrome traces whose values are worked
out by hand, and on the spans a traced run of the tiny cells records on
the CPU."""

from __future__ import annotations

import pytest

from portbench import run as R
from portbench.trace import Trace
from portbench.tests import conftest as C

SERVE = ("upload_ms.serve", "upload_idle_share.serve",
         "rank_select_ms.serve", "gnn_ms.serve", "host_sync_ms.serve",
         "host_enqueue_ms.serve")
TRAIN = ("feed_ms.train", "forward_ms.train", "backward_ms.train")
NETVLAD = {"num_clusters": 8, "encoder_dim": 512, "retrieval_hw": [48, 64],
           "dtype": "float32"}


def _trace(spans, ops):
    """spans: (name, start us, end us, thread); ops: (category, start,
    end, launch time, launching thread) with correlation ids in order."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "relpose." + n,
           "ts": s, "dur": e - s, "tid": t} for n, s, e, t in spans]
    for corr, (cat, s, e, at, tid) in enumerate(ops, 1):
        ev.append({"ph": "X", "cat": cat, "name": cat + str(corr), "ts": s,
                   "dur": e - s, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "cuda_runtime",
                   "name": "cudaLaunchKernel", "ts": at, "dur": 1,
                   "tid": tid, "args": {"correlation": corr}})
    return Trace(ev)


def _serve_trace():
    """Two batches: the first with every stage, the second an upload
    alone; the copies leave the device idle."""
    spans = [("service.query", 0, 100, 1), ("service.upload", 5, 25, 1),
             ("service.descriptor", 26, 40, 1), ("service.encode", 40, 55, 1),
             ("service.rank", 55, 60, 1), ("service.select", 60, 75, 1),
             ("select.window_read", 70, 74, 1), ("service.gather", 75, 80, 1),
             ("service.gnn", 80, 95, 1), ("stream.fetch", 100, 130, 1),
             ("service.query", 200, 260, 1), ("service.upload", 205, 215, 1)]
    ops = [("gpu_memcpy", 12, 30, 10, 1),     # upload 1: 18
           ("kernel", 31, 50, 30, 1),         # descriptor
           ("kernel", 50, 80, 45, 1),         # encode
           ("kernel", 80, 85, 57, 1),         # rank: 5
           ("kernel", 85, 88, 62, 1),         # select: 3
           ("kernel", 88, 90, 77, 1),         # gather
           ("kernel", 90, 110, 85, 1),        # gnn: 20
           ("gpu_memcpy", 110, 112, 105, 1),  # fetch
           ("gpu_memcpy", 208, 228, 207, 1)]  # upload 2: 20
    return _trace(spans, ops)


def _train_trace():
    """One step: a feed gather that launched nothing, the backward's
    kernel launched from a second thread inside `train.backward`, and a
    launch from that thread after it."""
    spans = [("feed.gather", 0, 10, 1), ("train.step", 10, 100, 1),
             ("train.forward", 12, 40, 1), ("train.backward", 40, 80, 1),
             ("train.optimizer", 80, 95, 1)]
    ops = [("kernel", 20, 45, 15, 1),         # forward: 25
           ("kernel", 50, 70, 50, 2),         # backward, thread 2: 20
           ("kernel", 85, 90, 85, 2),         # after the backward
           ("kernel", 90, 95, 82, 1)]         # optimizer
    return _trace(spans, ops)


def _read(name, tr):
    return R.read_metric(name, {"trace": tr})


def test_serve_readers_by_hand():
    tr = _serve_trace()
    assert tr.window_s == pytest.approx(260e-6)
    want = {
        # device ms of the copies in the two uploads, per upload
        "upload_ms.serve": (18 + 20) / 2 * 1e-3,
        # no kernel runs in either upload: 20 + 10 us of 260
        "upload_idle_share.serve": 100 * 30 / 260,
        # per rank instance: rank 5 + select 3 (its window read nests in
        # it and launched nothing)
        "rank_select_ms.serve": (5 + 3) * 1e-3,
        "gnn_ms.serve": 20e-3,
        # uploads 30 / 2 + window read 4 / 1 select + fetch 30 / 1
        "host_sync_ms.serve": (15 + 4 + 30) * 1e-3,
        # queries 100 + 60, less the nested uploads and window read
        "host_enqueue_ms.serve": (160 - 30 - 4) / 2 * 1e-3,
    }
    for name, value in want.items():
        assert _read(name, tr) == pytest.approx(value, rel=1e-9), name


def test_train_readers_by_hand():
    """The backward counts the kernel its second thread launched inside
    it and not the one launched after; a span with no device op reads
    None."""
    tr = _train_trace()
    assert _read("forward_ms.train", tr) == pytest.approx(25e-3)
    assert _read("backward_ms.train", tr) == pytest.approx(20e-3)
    assert _read("feed_ms.train", tr) is None


def test_kernels_launched_inside_an_upload_are_not_idle():
    spans = [("service.upload", 0, 50, 1)]
    ops = [("kernel", 10, 30, 5, 1), ("gpu_memcpy", 30, 60, 20, 1)]
    tr = _trace(spans, ops)
    # idle inside the upload: [0, 10) and [30, 50) of a 60 us window
    assert _read("upload_idle_share.serve", tr) == pytest.approx(
        100 * 30 / 60)
    assert _read("upload_ms.serve", tr) == pytest.approx((20 + 30) * 1e-3)


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_a_trace_without_the_programs_spans_reads_none(name):
    """The parent program, without spans, gives traces like this one: each
    reader reads None and the metric is left out."""
    tr = _trace([], [("kernel", 0, 10, 0, 1)])
    assert _read(name, tr) is None
    assert R.read_metric(name, {}) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench"))
    m = dict(C.TINY_MODEL, preset="R3")
    C.write_root(path, {
        "tiny-serve": ({"model": m, "retrieval": NETVLAD}, C.TINY_SERVE,
                       C.SERVE_LIMITS),
        "tiny-train": ({"model": m}, C.TINY_TRAIN, C.TRAIN_LIMITS)})
    return path


@pytest.mark.parametrize("cell,seconds,names", [
    ("tiny-serve", 5.0, ("host_sync_ms.serve", "host_enqueue_ms.serve")),
    ("tiny-train", 2.0, ())])
def test_a_traced_cpu_run_finds_the_programs_spans(root, cell, seconds,
                                                   names):
    """A traced run on the CPU records the program's spans: the host-time
    readers read them; the device-time readers have no device op to read
    there and leave their metrics out.  (The serve window is long enough
    for the stream's first slow batches to pass before the tracer's.)"""
    run = R.Run(R.Cell(cell, root), 2 ** 31 + 9, seconds, True, "cpu",
                None)
    rec = R.execute(run)
    out, _ = R.result_line(run, rec, True)
    got = out["metrics"]
    tr = rec["layer"]["trace"]
    assert tr is not None
    spans = {n for n, _, _, c in tr.host if c == "user_annotation"
             and n.startswith("relpose.")}
    if cell == "tiny-serve":
        assert {"relpose.service.query", "relpose.service.upload",
                "relpose.stream.fetch", "relpose.select.window_read"} <= spans
    else:
        assert {"relpose.feed.gather", "relpose.train.step",
                "relpose.train.backward"} <= spans
    for name in names:
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms"
    device_only = [n for n in SERVE + TRAIN if n not in names]
    assert not set(device_only) & set(got)
