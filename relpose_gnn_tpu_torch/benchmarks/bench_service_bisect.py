"""Per-stage bisect of the relocalization service's query path.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_service_bisect [--batch 128] [--db 4096]

Counterpart of the JAX package's `benchmarks/bench_service_bisect.py`.
Times each stage of `RelocalizationService._query_fn` alone (CUDA events,
median of `--iters` after warm-up), then the composed query:

  netvlad  resize to `--retrieval-hw` + VGG16 trunk + VLAD pooling
           (absent in shared-trunk mode)
  select   cosine similarities [B, M] + stochastic strided subsample
  encode   folded ResNet on the query pixels
  gnn      gather + compact edge-list GNN + pose recovery
  full     the composed query step

The database is made on the device (descriptors [M, Dv], embeddings
[M, D], poses), so `--db` can be of a deployment's size.  The stages are
chains of small launches timed through the host, so their sum can read
above or below `full`.

Prints {batch, db, stage_ms, ...} as one JSON line (and writes it to
`--json PATH`, which `bench_service --bisect-json` merges).  Runs on the
CUDA card unless `--device cpu` asks otherwise.
"""

from __future__ import annotations

import argparse
import sys

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util
from relpose_gnn_tpu_torch.benchmarks.bench_service import add_service_args
from relpose_gnn_tpu_torch.evaluation import serving
from relpose_gnn_tpu_torch.evaluation.service import (_unit_rows,
                                                      similarities)

STAGES = ("full", "netvlad", "select", "encode", "gnn")


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_service_args(ap, db=4096)
    ap.add_argument("--stages", default="all",
                    help="comma list of " + ",".join(STAGES))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    b, m = args.batch, args.db
    want = set(STAGES) if args.stages == "all" else set(
        args.stages.split(","))
    if want - set(STAGES):
        raise SystemExit(f"unknown stages {sorted(want - set(STAGES))}")

    svc = _synthetic.service_from_args(args, device)
    _synthetic.synth_database(svc, m)
    model_norm = _synthetic.make_norm(device)
    n = svc.cfg.seq_len
    q01 = _synthetic.synthetic_frames(
        device, b, args.height, args.width, args.seed + 11
    ).to(device).float() / 255.0

    q_emb = svc._encode(model_norm(q01))
    if svc.cfg.retrieval == "netvlad":
        q_desc = svc.netvlad(svc._netvlad_input(q01))
    else:
        q_desc = _unit_rows(q_emb[:, 0])
    nbrs = svc._select(similarities(q_desc, svc.db_desc), svc.db_valid, 0)
    adj = (~torch.eye(n, dtype=torch.bool, device=device)).expand(b, n, n)
    stages = {
        "full": lambda: svc.query(q01, model_norm, 0),
        "netvlad": lambda: svc.netvlad(svc._netvlad_input(q01)),
        "select": lambda: svc._select(
            similarities(q_desc, svc.db_desc), svc.db_valid, 0),
        "encode": lambda: svc._encode(model_norm(q01)),
        "gnn": lambda: serving.anchored_pose_step(
            svc.model, q_emb, svc.db_emb[nbrs], svc.db_poses[nbrs], adj),
    }
    if svc.cfg.retrieval != "netvlad":
        del stages["netvlad"]

    print(f"batch={b} db={m} {svc.cfg.retrieval}", flush=True)
    times = {}
    for name, fn in stages.items():
        if name not in want:
            continue
        times[name] = _util.median_ms(fn, args.iters, device=device)
        print(f"{name:8s} {times[name]:8.3f} ms  "
              f"({b / times[name] * 1e3:7.0f} q/s)", flush=True)
    parts = [k for k in times if k != "full"]
    if "full" in times and len(parts) == len(stages) - 1:
        total = sum(times[k] for k in parts)
        print(f"sum(stages) {total:.3f} ms vs full {times['full']:.3f} ms "
              f"(difference {total - times['full']:+.3f} ms)", flush=True)
    record = {"batch": b, "db": m, "retrieval_mode": svc.cfg.retrieval,
              "retrieval_hw": list(args.retrieval_hw),
              "rank_dtype": args.rank_dtype, "dtype": args.dtype,
              "stage_ms": times, **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
