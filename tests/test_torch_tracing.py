"""The port's spans and counters (`utils/profiling.py::span`,
`retrieval/subsample.py::WINDOW_CALLS` / `WINDOW_FALLBACKS`) on the CPU:
a served batch's spans nest in its `service.query`, a train step's in its
`train.step`; with no profiler running a span is one shared no-op and
enters no profiler range; a window that cannot fill the graph counts a
fallback, opens `select.full_sort` and gives the full sort's answer.

Spans are read from the profiler's exported Chrome trace, as the
benchmark reads them.
"""

import json

import numpy as np
import pytest
import torch

from relpose_gnn_tpu_torch.data.device_cache import DeviceCachedFeed
from relpose_gnn_tpu_torch.evaluation.service import (RelocalizationService,
                                                      ServiceConfig)
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.retrieval import netvlad_index, subsample
from relpose_gnn_tpu_torch.training import trainer
from relpose_gnn_tpu_torch.utils import profiling

SEQ, H, W = 4, 32, 40
MODEL_KW = dict(num_nodes=SEQ, feat_dim=32, edge_dim=32, node_dim=32, knn=2,
                backbone="resnet18")
QUERY_CHILDREN = ("service.upload", "service.descriptor", "service.encode",
                  "service.rank", "service.select", "service.gather",
                  "service.gnn")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model(**kw):
    model = RelPoseGNN(RelPoseGNNConfig(**MODEL_KW, **kw))
    init_weights(model, torch.Generator().manual_seed(3))
    return model


def _norm(x01):
    return (x01 - 0.5) / 0.25


def _service(mode, deterministic, candidates):
    netvlad = (netvlad_index.seeded_encoder(4, 512, None, seed=5)
               if mode == "netvlad" else None)
    cfg = ServiceConfig(seq_len=SEQ, sampling_period=2, retrieval_hw=(24, 32),
                        deterministic=deterministic, retrieval=mode,
                        retrieval_candidates=candidates)
    svc = RelocalizationService(_model(droprate=0.0).eval(), netvlad, cfg,
                                device="cpu")
    rng = np.random.default_rng(0)
    svc.build(rng.random((24, H, W, 3)).astype(np.float32),
              rng.normal(size=(24, 6)).astype(np.float32), _norm, batch=8)
    return svc


def _spans(prof, tmp_path):
    """[(name without the prefix, start, end, thread)] of the port's
    spans in the profiler's exported trace."""
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    pre = profiling.SPAN_PREFIX
    return [(e["name"][len(pre):], float(e["ts"]),
             float(e["ts"]) + float(e["dur"]), e.get("tid"))
            for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(pre)]


def _inside(spans, outer, name):
    return [s for s in spans if s[0] == name and outer[3] == s[3]
            and outer[1] <= s[1] and s[2] <= outer[2]]


def _profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.parametrize("mode,deterministic,candidates", [
    ("netvlad", True, 8), ("netvlad", False, 8), ("shared-trunk", False, 8),
    ("shared-trunk", False, None)])
def test_served_batches_nest_their_spans(tmp_path, mode, deterministic,
                                         candidates):
    """Two batches through `query_stream`: per batch one `service.query`
    holding one span of each stage, and one `stream.fetch` after it; the
    windowed selection's host read inside `service.select`, and a
    `select.full_sort` for each fallback counted."""
    svc = _service(mode, deterministic, candidates)
    batches = [np.random.default_rng(i).random((3, H, W, 3)).astype(
        np.float32) for i in (1, 2)]
    calls, falls = subsample.WINDOW_CALLS, subsample.WINDOW_FALLBACKS
    with _profile() as prof:
        out = list(svc.query_stream(batches, _norm, depth=2, rng=7))
    assert len(out) == 2
    windowed = not deterministic and candidates is not None
    assert subsample.WINDOW_CALLS - calls == (2 if windowed else 0)
    fell = subsample.WINDOW_FALLBACKS - falls
    spans = _spans(prof, tmp_path)
    queries = sorted(s for s in spans if s[0] == "service.query")
    fetches = sorted(s for s in spans if s[0] == "stream.fetch")
    assert len(queries) == len(fetches) == 2
    # FIFO: the n-th fetch answers the n-th query, after the last enqueue
    assert all(f[1] >= queries[-1][2] for f in fetches)
    for q in queries:
        for name in QUERY_CHILDREN:
            assert len(_inside(spans, q, name)) == 1, (name, q)
        (select,) = _inside(spans, q, "service.select")
        reads = _inside(spans, select, "select.window_read")
        assert len(reads) == (1 if windowed else 0)
    assert len([s for s in spans if s[0] == "select.full_sort"]) == fell
    for s in spans:
        if s[0].startswith(("service.", "select.")) and s[0] != \
                "service.query":
            assert any(_inside(spans, q, s[0]) for q in queries), s


def _store(n=6, seed=0):
    rng = np.random.default_rng(seed)

    class Store:
        mean, std = [0.5] * 3, [0.25] * 3
        images = rng.integers(0, 256, (n, SEQ, H, W, 3), dtype=np.uint8)
        poses = rng.normal(size=(n, SEQ, 6)).astype(np.float32)

        def __len__(self):
            return n

        def batch(self, idx):
            return {"images": self.images[idx], "poses": self.poses[idx],
                    "adj": np.ones((len(idx), SEQ, SEQ), bool)}

    return Store()


def test_train_step_spans_nest(tmp_path):
    """A train step fed by `DeviceCachedFeed`: `feed.gather`, then
    `train.step` holding `train.forward`, `train.backward` and
    `train.optimizer` once each, in that order."""
    cfg = trainer.TrainerConfig()
    state = trainer.create_train_state(_model(), cfg)
    step = trainer.make_train_step(cfg)
    feed = DeviceCachedFeed(_store(), "cpu")
    batches = feed.epoch(0, 2)
    with _profile() as prof:
        metrics = step(state, next(batches), 0)
    assert np.isfinite(float(metrics["loss"]))
    spans = _spans(prof, tmp_path)
    (gather,) = [s for s in spans if s[0] == "feed.gather"]
    (outer,) = [s for s in spans if s[0] == "train.step"]
    assert gather[2] <= outer[1]
    inner = [_inside(spans, outer, n) for n in
             ("train.forward", "train.backward", "train.optimizer")]
    assert all(len(x) == 1 for x in inner)
    starts = [x[0][1] for x in inner]
    assert starts == sorted(starts)


def test_span_with_no_profiler_is_a_shared_no_op(monkeypatch):
    """No profiler running: `span()` returns one shared null context, and
    neither a served batch nor a train step enters a profiler range."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    off = profiling.span("service.query")
    assert off is profiling.span("train.step")
    with off as got:
        assert got is None
    svc = _service("shared-trunk", False, 8)
    q = np.random.default_rng(1).random((3, H, W, 3)).astype(np.float32)
    assert len(list(svc.query_stream([q, q], _norm, depth=2, rng=7))) == 2
    cfg = trainer.TrainerConfig()
    state = trainer.create_train_state(_model(), cfg)
    trainer.make_train_step(cfg)(
        state, next(DeviceCachedFeed(_store(), "cpu").epoch(0, 2)), 0)


@pytest.mark.parametrize("candidates,falls", [(40, 0), (3, 1)])
def test_window_shortfall_falls_back_to_the_full_sort(tmp_path, candidates,
                                                      falls):
    """A window that fills k selections counts a call and no fallback; one
    of k entries (k = 3 at period 2 needs 5 survivors) counts a fallback
    and opens `select.full_sort`.  Both give the full sort's answer."""
    gen = torch.Generator().manual_seed(4)
    sim = torch.rand(2, 64, generator=gen)
    invalid = torch.zeros(64, dtype=torch.bool)
    invalid[::7] = True
    want = subsample.subsample_neighbors_batch(11, sim, invalid, 3, 2)
    calls, fell = subsample.WINDOW_CALLS, subsample.WINDOW_FALLBACKS
    with _profile() as prof:
        got = subsample.subsample_neighbors_batch(11, sim, invalid, 3, 2,
                                                  candidates=candidates)
    assert torch.equal(got, want)
    assert subsample.WINDOW_CALLS - calls == 1
    assert subsample.WINDOW_FALLBACKS - fell == falls
    names = [s[0] for s in _spans(prof, tmp_path)]
    assert names.count("select.window_read") == 1
    assert names.count("select.full_sort") == falls
