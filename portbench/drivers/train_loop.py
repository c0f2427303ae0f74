"""Driver `train_loop`: the train step fed by the store on the card, as
`run_training` drives it (`DeviceCachedFeed.epoch` -> `make_train_step`).

Set-up: weights from the seed; the port's model (BatchNorm in train mode,
dropout) in a `create_train_state`; a store of `graphs` graphs of
`num_nodes` frames of a scene made in memory (never written to disk) and
uploaded by `DeviceCachedFeed`; the first `check_steps` steps of epoch 0
through the window's own step and feed, keeping what the check compares
(check_train.py).  The window then goes on with the same state and
epoch.

Window: steps until `seconds` have passed, then a synchronise;
`train_throughput` is every step's graphs over all the window's time.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import check_train, program, scenes
from portbench.reference import nets, params


class _Store:
    """The store as `DeviceCachedFeed` reads one: its length, its
    normalisation and `batch(indices)`."""

    def __init__(self, images, poses, mean, std):
        self.images, self.poses = images, poses
        self.adj = np.broadcast_to(~np.eye(images.shape[1], dtype=bool),
                                   (len(images),) + (images.shape[1],) * 2)
        self.mean, self.std = mean, std

    def __len__(self):
        return len(self.images)

    def batch(self, indices):
        return {"images": self.images[indices], "poses": self.poses[indices],
                "adj": np.ascontiguousarray(self.adj[indices])}


def _inputs(run) -> check_train.TrainInputs:
    cfg, t, dev, seed = run.config, run.traffic, run.device, run.seed
    m = cfg["model"]
    w = params.relpose_weights(m, scenes.generator(seed, "weights", dev))
    scene = scenes.Scene(seed, m["image_hw"], t["strip_columns"], dev)
    off = scenes.graph_offsets(scene, t["graphs"], m["num_nodes"],
                               t["node_stride"], "graphs")
    images = scene.frames(off.reshape(-1), "graph_noise").reshape(
        t["graphs"], m["num_nodes"], *m["image_hw"], 3)
    poses = scene.poses(off.reshape(-1)).reshape(t["graphs"],
                                                 m["num_nodes"], 6)
    mean, std = scenes.normalization(t["pixel_stats"])
    return check_train.TrainInputs(cfg, t, w, images, poses, mean, std,
                                   scenes.seed_of(seed, "feed"),
                                   scenes.seed_of(seed, "train"), dev)


def _epochs(feed, inp, batch):
    """Epoch 0 from the feed seed, then epoch e from `seed_of(it, e)`."""
    e = 0
    while True:
        seed = inp.feed_seed if e == 0 else scenes.seed_of(inp.feed_seed, e)
        yield from feed.epoch(seed, batch)
        e += 1


def run(run) -> dict:
    from relpose_gnn_tpu_torch.data.device_cache import DeviceCachedFeed
    from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                        create_train_state,
                                                        make_train_step)
    t, dev = run.traffic, run.device
    inp = _inputs(run)
    tcfg = TrainerConfig(lr=t["lr"], weight_decay=t["weight_decay"],
                         sax=t["sax"], saq=t["saq"], srx=t["srx"],
                         srq=t["srq"])
    state = create_train_state(program.pose_model(inp.m, inp.w, dev), tcfg)
    step = make_train_step(tcfg)
    if run.fault:
        step = run.fault.train_step(step)
    feed = DeviceCachedFeed(_Store(inp.images, inp.poses,
                                   *scenes.normalization(t["pixel_stats"])),
                            dev)
    batches = _epochs(feed, inp, t["batch"])
    opt = state.optimizer
    p0 = [p.detach().clone() for p in opt.params]
    losses, graphs = [], []
    # the program's graph of each checked step, from the model's output
    # (pred_abs, pred_rel, adj, aux): the reference follows it
    hook = state.model.register_forward_hook(
        lambda mod, args, out: graphs.append(out[2].detach().cpu()))
    for s in range(t["check_steps"]):
        losses.append(step(state, next(batches), inp.train_seed)["loss"])
        if s == 0:
            beta1 = opt.adam.param_groups[0]["betas"][0]
            grad = {n: float((opt.adam.state[p]["exp_avg"] / (1 - beta1)
                              - t["weight_decay"] * q).norm())
                    for n, p, q in zip(opt.names, opt.params, p0)}
    hook.remove()
    update = {n: float((p.detach() - q).norm())
              for n, p, q in zip(opt.names, opt.params, p0)}
    prog = {"loss": [float(x) for x in losses], "grad_norm": grad,
            "update_norm": update, "graphs": graphs}
    del p0
    run.sync()

    tracer = run.tracer
    tracer.hook_optimizer(getattr(opt, "adam", None), "optimizer")
    setup_s = run.setup_done()
    steps, failed = 0, 0
    t0 = time.perf_counter()
    with tracer:
        while time.perf_counter() < t0 + run.seconds:
            last = step(state, next(batches), inp.train_seed)["loss"]
            steps += 1
            tracer.step()
        run.sync()
    elapsed = time.perf_counter() - t0
    if not np.isfinite(float(last)):
        failed = t["batch"]
    peak = run.peak_bytes()
    del state, step, feed, batches, opt
    torch.cuda.empty_cache()

    ref = check_train.reference_steps(inp, nets.Precision("float32"),
                                      t["check_steps"], prog["graphs"])
    trained = steps * t["batch"]
    return {
        "setup_s": setup_s,
        "metrics": {"train_throughput": trained / elapsed},
        "attempted": trained, "failed": failed,
        "numbers": check_train.judge(ref, prog),
        "memory_peak_bytes": peak,
        "layer": {"trace": tracer.trace, "per_step": t["batch"],
                  "steps_traced": tracer.steps_recorded},
    }
