"""Whether the train step is right, judged by the reference.

Set-up drives the program's train step through its first three steps
(the window's own call and feed) and keeps what it needs: each step's
loss, the first step's gradient as Adam got it (from Adam's first moment
after one step: m = (1 - beta1)(g + wd p0)), and each leaf's change over
the three steps.  The reference runs the same three steps from the same
weights and rows in float32.  The numbers compared:

* `graph_gap`: how far the program's graph of each step (read from the
  model's output by a forward hook) is from the reference's own kNN-4
  graph of its float32 embeddings: the largest excess of a chosen
  source's distance over the 4th-nearest one, relative to it.  The
  reference then trains on the program's graphs, so that a near-tie
  ordered otherwise in bfloat16 does not decide the numbers below;
* `loss_gap`: the widest gap of a step's loss, over the reference's data
  term (the weighted L1 sum, which is positive);
* `grad_gap`: the median over the leaves of the gap between the norms
  of the first gradient, over the reference's norm of that leaf or of the
  median leaf, whichever is larger (the worst leaf's reading is given
  beside it: a few leaves, BatchNorm's of the stem above all, sum
  gradients that cancel over a whole batch of pixels, and read a tenth
  or more in bfloat16 on every seed);
* `update_gap`: the same for the change of each leaf over three steps.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's (the absolute heads, which the loss never reads, and the
  absolute criterion) are left out: Adam moves them by round-off alone.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import nets
from portbench.reference import train as rtrain

class TrainInputs:
    """What both sides get: weights, the store, its normalisation, the
    feed's and the step's seeds."""

    def __init__(self, config: dict, traffic: dict, weights: dict,
                 images: np.ndarray, poses: np.ndarray, mean, std,
                 feed_seed: int, train_seed: int, device):
        self.m, self.t, self.w = config["model"], traffic, weights
        self.images, self.poses = images, poses
        self.mean = torch.as_tensor(mean, device=device)
        self.std = torch.as_tensor(std, device=device)
        self.feed_seed, self.train_seed = feed_seed, train_seed
        self.device = device

    def rows(self, step: int) -> np.ndarray:
        """The store rows of step `step` of the first epoch: the feed's
        protocol, a permutation from `default_rng(feed_seed)` cut into
        batches."""
        b = self.t["batch"]
        order = np.random.default_rng(self.feed_seed).permutation(
            len(self.images))
        return order[step * b:(step + 1) * b]

    def to_norm(self, images: np.ndarray) -> torch.Tensor:
        x = torch.as_tensor(images, device=self.device).float() / 255.0
        return (x - self.mean) / self.std


def leaves(weights: dict) -> dict:
    """The trained leaves, by the optimizer's names: every float weight
    of the model and the two criterion sets."""
    return {f"model.{k}": v for k, v in weights.items()
            if v.is_floating_point() and not k.endswith(
                ("running_mean", "running_var"))}


def criterion_init(t: dict) -> dict:
    return {"criterion.sax": t["sax"], "criterion.saq": t["saq"],
            "criterion_R.sax": t["srx"], "criterion_R.saq": t["srq"]}


def reference_steps(inp: TrainInputs, prec: nets.Precision,
                    steps: int = 3, graphs: list | None = None) -> dict:
    """The reference's first `steps` train steps: each loss and data
    term, the first gradient's norm per leaf, each leaf's change and each
    step's graph.  With `graphs` (the other side's graph of each step,
    adj [B, N, N]) it trains on those, and `graph_gap` says how far they
    are from its own kNN graphs."""
    dev = inp.device
    params = {k: v.detach().clone().float().requires_grad_(True)
              for k, v in leaves(inp.w).items()}
    for k, v in criterion_init(inp.t).items():
        params[k] = torch.tensor(float(v), device=dev, requires_grad=True)
    start = {k: v.detach().clone() for k, v in params.items()}
    sd = {k[len("model."):]: v for k, v in params.items()
          if k.startswith("model.")}
    crit = {"srx": params["criterion_R.sax"],
            "srq": params["criterion_R.saq"]}
    opt = rtrain.Adam(params, inp.t["lr"], inp.t["weight_decay"])
    out = {"loss": [], "data": [], "graphs": [], "graph_gap": 0.0}
    n, k = inp.m["num_nodes"], inp.m["knn"]
    for s in range(steps):
        idx = inp.rows(s)
        images = inp.to_norm(inp.images[idx])
        poses = torch.as_tensor(inp.poses[idx], device=dev)
        drop = rtrain.dropout_fn(inp.train_seed, s, inp.m["droprate"], dev)
        adj = None if graphs is None else graphs[s].to(dev)
        if adj is not None and tuple(adj.shape) != (len(idx), n, n):
            # a graph of other rows
            out["graph_gap"] = out["graph_mismatch"] = float("inf")
            break
        loss, data, x, edges = rtrain.loss(sd, crit, inp.m, images, poses,
                                           prec, drop, adj)
        if edges is None:   # not a kNN-k graph: no step to follow
            out["graph_gap"] = out["graph_mismatch"] = float("inf")
            break
        if adj is not None:
            own = rtrain.adjacency(nets.knn(x.detach(), k)[:2], n)
            out["graph_gap"] = max(out["graph_gap"],
                                   rtrain.graph_gap(x, adj, k))
            out["graph_mismatch"] = max(
                out.get("graph_mismatch", 0.0),
                float((adj & ~own).sum() / adj.sum().clamp_min(1)))
        out["graphs"].append(rtrain.adjacency(edges, n).cpu())
        del x
        names = list(params)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                 for k, g in zip(names, grads)}
        if s == 0:
            out["grad_norm"] = {k: float(g.norm()) for k, g in grads.items()}
        out["loss"].append(float(loss.detach()))
        out["data"].append(float(data.detach()))
        del loss, data, images
        opt.step(grads)
        del grads
    out["update_norm"] = {k: float((params[k].detach() - start[k]).norm())
                          for k in params}
    out.setdefault("grad_norm", {})
    return out


def _finite(x: float) -> float:
    return x if np.isfinite(x) else float("inf")


def judge(ref: dict, prog: dict) -> dict:
    """The numbers compared, program against reference, and beside them
    the worst leaf's readings and each step's loss gap."""
    loss = [_finite(abs(p - r) / d) for p, r, d in zip(
        prog["loss"], ref["loss"], ref["data"])]
    g_ref = ref["grad_norm"]
    if not g_ref:   # the reference could not follow the program's steps
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "update_gap": float("inf"),
                "graph_mismatch": ref.get("graph_mismatch", float("inf"))}
    g_med = float(np.median(list(g_ref.values())))

    def gaps(p, r, keys):
        med = float(np.median([r[k] for k in keys]))
        return {k: _finite(abs(p.get(k, float("nan")) - r[k])
                           / max(r[k], med, 1e-30)) for k in keys}

    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    grad = gaps(prog["grad_norm"], g_ref, list(g_ref))
    update = gaps(prog["update_norm"], ref["update_norm"], moved)
    out = {"loss_gap": loss[0] if loss else float("inf"),
           "graph_mismatch": ref.get("graph_mismatch", 0.0),
           "graph_gap": ref.get("graph_gap", 0.0),
           "grad_gap": float(np.median(list(grad.values()))),
           "update_gap": float(np.median(list(update.values()))),
           "grad_gap_worst": max(grad.values(), default=float("inf")),
           "update_gap_worst": max(update.values(), default=float("inf")),
           "leaves": len(g_ref), "leaves_moved": len(moved)}
    for i, v in enumerate(loss[1:]):
        out[f"loss_gap_step{i + 2}"] = v
    for name, d in (("grad", grad), ("update", update)):
        for i, k in enumerate(sorted(d, key=d.get, reverse=True)[:2]):
            out[f"{name}_worst{i}"] = f"{k} {d[k]:.4g}"
    return out
