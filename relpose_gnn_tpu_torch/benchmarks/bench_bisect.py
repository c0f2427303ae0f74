"""Bisect of the cached serving step: the whole step, the backbone, the GNN.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_bisect [--batch 512]

Counterpart of the JAX package's `benchmarks/bench_bisect.py`.  At R3's
full width (ResNet34 BN-folded, dims 2048, 8-node graphs, bf16, seeded
weights) it times, in turns (CUDA events, median of `--iters` after
warm-up):

  full           `evaluation/serving.py::make_cached_eval_step` over the
                 query pixels [B, 256, 341, 3] and 7 cached neighbour
                 embeddings a query
  backbone_only  `encode_nodes` of the folded model on the query pixels
  gnn_only       `from_embeddings` on [query embedding | 7 cached ones],
                 `nearest_neighbor` and the anchor's recovery
                 `poses[nbr] - pred_rel[nbr, query]`

and reports `bb + gnn - full`, how much of the two parts the composed
step does not add up to.  The graph is the one the port's cached step
builds: the dynamic kNN-4 graph as a compact edge list (the JAX script
passes a dense all-pairs adjacency, which the kNN graph replaces in the
same way; the compact list is the serving form here).  `full` and
`gnn_only` launch the attention kernel twice a call (two GNN passes);
`attention_launches` counts them.

Prints one JSON line (and writes it to `--json PATH`).  Runs on the CUDA
card unless `--device cpu` asks otherwise.
"""

from __future__ import annotations

import argparse
import sys

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util
from relpose_gnn_tpu_torch.evaluation import serving
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN
from relpose_gnn_tpu_torch.ops import att_core
from relpose_gnn_tpu_torch.ops import graph as graph_ops

STEPS = ("full", "backbone_only", "gnn_only")


def make_steps(model: RelPoseGNN, q: torch.Tensor, emb: torch.Tensor,
               poses: torch.Tensor, adj: torch.Tensor,
               x0: torch.Tensor) -> dict:
    """The three steps on fixed inputs: q [B, H, W, 3] query pixels, emb
    [B, N-1, D] cached neighbour embeddings, poses [B, N, 6] (row 0 the
    query's, unused), adj [B, N, N], x0 [B, D] a query embedding for
    `gnn_only`.  Each returns the values the JAX script sums."""
    cached = serving.make_cached_eval_step(model)

    def full():
        return cached(q, emb, poses[:, 1:], adj)["pred"]

    def backbone_only():
        return model.encode_nodes(q[:, None])[:, 0]

    def gnn_only():
        x = torch.cat([x0[:, None], emb.to(x0.dtype)], dim=1)
        _, pred_rel, _, aux = model.from_embeddings(x, adj)
        nbr = graph_ops.nearest_neighbor(aux["node_feats"], node=0)
        rows = torch.arange(x.shape[0], device=x.device)
        return poses[rows, nbr] - pred_rel[rows, nbr, 0]

    return {"full": full, "backbone_only": backbone_only,
            "gnn_only": gnn_only}


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    _synthetic.add_model_args(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model, _ = _synthetic.models_from_args(args, device, with_netvlad=False)
    n, feat = model.cfg.num_nodes, model.cfg.feat_dim
    b, h, w = args.batch, args.height, args.width
    gen = torch.Generator(device=device).manual_seed(args.seed + 7)
    q = torch.randn(b, h, w, 3, device=device, generator=gen)
    emb = torch.randn(b, n - 1, feat, device=device, generator=gen)
    poses = torch.randn(b, n, 6, device=device, generator=gen)
    adj = (~torch.eye(n, dtype=torch.bool, device=device)).expand(b, n, n)
    x0 = torch.randn(b, feat, device=device, generator=gen)
    steps = make_steps(model, q, emb, poses, adj, x0)

    before = att_core.LAUNCHES
    ms = _util.in_turns(steps, args.iters, args.warmup, device)
    launches = att_core.LAUNCHES - before
    over = ms["backbone_only"] + ms["gnn_only"] - ms["full"]
    print(f"batch {b}: full {ms['full']:.3f} ms | backbone "
          f"{ms['backbone_only']:.3f} ms | gnn+recovery "
          f"{ms['gnn_only']:.3f} ms | bb+gnn "
          f"{ms['backbone_only'] + ms['gnn_only']:.3f} ms (difference "
          f"{over:+.3f} ms); full {b / ms['full'] * 1e3:.0f} q/s",
          flush=True)
    record = {"batch": b, "model": args.model_name, "dtype": args.dtype,
              "hw": [h, w], "nodes": n, "step_ms": ms,
              "bb_plus_gnn_ms": ms["backbone_only"] + ms["gnn_only"],
              "overlap_ms": over, "full_qps": b / ms["full"] * 1e3,
              "iters": args.iters, "warmup": args.warmup,
              "attention_launches": launches,
              **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
