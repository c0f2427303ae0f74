"""Driver `serve_stream`: the relocalization service under a closed loop of
query batches through `RelocalizationService.query_stream`.

Set-up: weights from the seed on the card; the service (its own BN fold
and compact edge list); a database of `db_live` frames of a scene in
capacity `db_capacity`, filled through `build()`; a pool of
`pool_batches` distinct host uint8 batches; `warm_batches` batches through
the stream (the first run in a checkout builds kernel #1 there).

Window: one client keeps handing batches (batch i is pool batch i mod
the pool) to `query_stream(depth)`, whose batch i draws with
`fold_in(stream seed, i)`, until `seconds` have passed, then drains.  A
request is one batch: its time runs from when the stream pulled it to
when its answers were on the host.  `query_throughput` counts the queries
answered inside the window over its seconds; `request_p95_ms` is the 95th
percentile over every request handed in the window.  A traced run hands
the same percentile to the readers, for a cell that reports it per layer.

Check: the reference judges a sample of the answered batches, drawn from
the seed (check_serve.py).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check_serve, program, scenes
from portbench.reference import encoders, params


def _inputs(run) -> check_serve.ServeInputs:
    cfg, t, dev, seed = run.config, run.traffic, run.device, run.seed
    m, r = cfg["model"], cfg.get("retrieval")
    pose_w = params.relpose_weights(m, scenes.generator(seed, "weights",
                                                        dev))
    netvlad_w = None
    if t["retrieval"] == "netvlad":
        netvlad_w = params.make_weights(
            params.netvlad_spec(r), scenes.generator(seed, "netvlad", dev))
    scene = scenes.Scene(seed, m["image_hw"], t["strip_columns"], dev)
    db_off = scene.offsets(t["db_live"], "db")
    pool = scene.frames(scene.offsets(t["pool_batches"] * t["batch"],
                                      "queries"), "query_noise")
    mean, std = scenes.normalization(t["pixel_stats"])
    return check_serve.ServeInputs(
        cfg, t, pose_w, netvlad_w, scene.frames(db_off, "db_noise"),
        scene.poses(db_off), pool, mean, std,
        scenes.seed_of(seed, "stream"), dev)


def _service(run, inp):
    from relpose_gnn_tpu_torch.evaluation.service import (
        RelocalizationService, ServiceConfig)
    t, m = run.traffic, inp.m
    model = program.pose_model(m, inp.pose_w, run.device)
    netvlad = None
    if inp.netvlad_w is not None:
        netvlad = program.netvlad_model(inp.r, inp.netvlad_w, run.device,
                                        inp.r["dtype"])
    cfg = ServiceConfig(
        seq_len=m["num_nodes"], sampling_period=t["sampling_period"],
        retrieval_hw=tuple((inp.r or {}).get("retrieval_hw", (192, 256))),
        deterministic=t["deterministic"],
        retrieval_candidates=t["retrieval_candidates"],
        capacity=t["db_capacity"], retrieval=t["retrieval"],
        rank_dtype=t["rank_dtype"])
    return RelocalizationService(model, netvlad, cfg, device=run.device)


def run(run) -> dict:
    t = run.traffic
    inp = _inputs(run)

    def model_norm(x01):
        return (x01 - inp.mean) / inp.std

    svc = _service(run, inp)
    svc.build(inp.db_frames, inp.db_poses, model_norm,
              batch=t["build_batch"])
    svc = run.fault.service(svc) if run.fault else svc
    n_pool = t["pool_batches"]
    pool = [inp.query_batch(j) for j in range(n_pool)]
    for _ in svc.query_stream(pool[:t["warm_batches"]], model_norm,
                              depth=t["depth"], rng=inp.stream_seed):
        pass
    run.sync()

    tracer = run.tracer
    tracer.hook_module(svc.netvlad, "retrieval_trunk")
    tracer.hook_module(getattr(svc.model, encoders.find(
        inp.m["backbone"]).MODULE, None), "encode")
    handed, done, answers = [], [], []
    setup_s = run.setup_done()
    t0 = time.perf_counter()
    end = t0 + run.seconds

    def client():
        i = 0
        while time.perf_counter() < end:
            handed.append(time.perf_counter())
            yield pool[i % n_pool]
            i += 1

    with tracer:
        for out in svc.query_stream(client(), model_norm, depth=t["depth"],
                                    rng=inp.stream_seed):
            done.append(time.perf_counter())
            answers.append(out)
            tracer.step()
    peak = run.peak_bytes()
    handed, done = np.asarray(handed), np.asarray(done)
    b = t["batch"]
    in_window = int(np.sum(done <= end))
    lat_ms = (done - handed) * 1e3
    p95_ms = float(np.percentile(lat_ms, 95))
    failed = sum(int(np.sum(~np.isfinite(a["pose"]).all(1)))
                 for a in answers)
    del svc
    torch.cuda.empty_cache()

    rng = np.random.default_rng(scenes.seed_of(run.seed, "check"))
    sample = sorted(rng.choice(len(answers), size=min(
        t["check_batches"], len(answers)), replace=False).tolist())
    numbers = check_serve.judge(inp, {i: answers[i] for i in sample},
                                run.limits["tie_margin"])
    return {
        "setup_s": setup_s,
        "metrics": {"query_throughput": b * in_window / run.seconds,
                    "request_p95_ms": p95_ms},
        "attempted": b * len(handed), "failed": failed,
        "numbers": numbers, "memory_peak_bytes": peak,
        "layer": {"trace": tracer.trace, "per_step": b,
                  "steps_traced": tracer.steps_recorded,
                  "request_p95_ms": p95_ms,
                  "edges_per_batch": b * run.config["model"][
                      "num_nodes"] * run.config["model"]["knn"],
                  "att_core_in_bytes": 2 if run.config["model"][
                      "dtype"] == "bfloat16" else 4},
    }
