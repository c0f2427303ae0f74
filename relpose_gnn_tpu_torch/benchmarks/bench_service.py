"""Benchmark the end-to-end relocalization service on the card: retrieval +
graph assembly + GNN + pose recovery per query.

    python -m relpose_gnn_tpu_torch.benchmarks.bench_service --synth-db --db 2048
    python -m relpose_gnn_tpu_torch.benchmarks.bench_service \
        --retrieval-mode shared-trunk --json service.json

Counterpart of the JAX package's `benchmarks/bench_service.py`.  Unlike
`bench_eval.py` (the cached eval step over prebuilt graphs), this times
the whole query path of `evaluation/service.py::RelocalizationService`,
retrieval per query included.

Legs:
  device-resident  `query` on a float batch already on the card: CUDA
                   events around each step, median of `--iters` after
                   warm-up; q/s = batch / median.  `mfu` is the step's
                   FLOPs, counted by `_util.count_flops` over one step
                   (matrix products and convolutions, and the attention
                   kernel at 3·E·C² a call; elementwise work is not
                   counted), over the step's time and the H100's dense
                   bf16 peak (989 TFLOP/s).
  host uint8       what a server does with uint8 frames on the host:
                   per-batch synchronous `query` (upload, step, read back)
                   against the pipelined `query_stream` at depth 2, host
                   clock over `--host-iters` distinct batches.

`--synth-db` makes the tables on the device (random unit-norm descriptors,
embeddings, poses) instead of embedding frames: the query path reads only
those tensors, so a deployment-sized `--db` costs no embedding pass.
Without it `--db` synthetic frames are built through `build()`.

Prints the record as one JSON line (and writes it to `--json PATH`).
Runs on the CUDA card unless `--device cpu` asks otherwise (a CPU run
says nothing about the card: `mfu` is null there).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _synthetic, _util

PROTOCOL = ("full service (retrieval in the loop): retrieval + graph "
            "assembly + GNN + pose recovery per query")


def add_service_args(ap: argparse.ArgumentParser, db: int) -> None:
    ap.add_argument("--batch", type=int, default=128, help="query batch")
    ap.add_argument("--db", type=int, default=db, help="database frames")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--retrieval-hw", type=int, nargs=2, default=(192, 256),
                    help="NetVLAD input size")
    ap.add_argument("--retrieval-mode", default="netvlad",
                    choices=("netvlad", "shared-trunk"),
                    help="'shared-trunk' ranks neighbours by cosine over "
                         "the backbone embeddings the query step already "
                         "computes; a semantic knob, see "
                         "ServiceConfig.retrieval")
    ap.add_argument("--rank-dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="descriptor-table type for the ranking")
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    _synthetic.add_model_args(ap)


@torch.inference_mode()
def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_service_args(ap, db=128)
    ap.add_argument("--synth-db", action="store_true",
                    help="make the tables on the device instead of "
                         "embedding --db frames")
    ap.add_argument("--skip-device-leg", action="store_true",
                    help="only run the host-uint8 legs")
    ap.add_argument("--skip-host-legs", action="store_true",
                    help="device-resident leg only")
    ap.add_argument("--host-iters", type=int, default=10)
    ap.add_argument("--bisect-json", default="",
                    help="merge a per-stage record written by "
                         "bench_service_bisect --json into 'stage_ms'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    h, w, m, batch = args.height, args.width, args.db, args.batch

    svc = _synthetic.service_from_args(args, device)
    model_norm = _synthetic.make_norm(device)
    if args.synth_db:
        _synthetic.synth_database(svc, m)
    else:
        frames = _synthetic.synthetic_frames(device, m, h, w, args.seed + 10)
        rng = np.random.default_rng(args.seed)
        svc.build(frames.numpy(), rng.normal(size=(m, 6)).astype(np.float32),
                  model_norm, batch=32)

    q8 = _synthetic.synthetic_frames(device, batch, h, w, args.seed + 11)
    q01 = q8.to(device).float() / 255.0
    record = {"protocol": PROTOCOL, "batch": batch, "db": m,
              "retrieval_mode": args.retrieval_mode,
              "retrieval_hw": list(args.retrieval_hw),
              "rank_dtype": args.rank_dtype, "dtype": args.dtype,
              "model": args.model_name, "hw": [h, w],
              **_util.device_record(device)}

    if not args.skip_device_leg:
        seeds = iter(range(10 ** 9))

        def step():
            return svc.query(q01, model_norm, next(seeds))

        _util.reset_peak_memory(device)
        ms = _util.median_ms(step, args.iters, device=device)
        flops = _util.count_flops(step)
        mfu = _util.mfu(flops, ms, device)
        qps = batch / ms * 1e3
        print(f"service (retrieval+graph+GNN+pose): {qps:.0f} queries/s "
              f"({ms / batch:.4f} ms/query)", flush=True)
        record.update(qps=qps, step_ms=ms, ms_per_query=ms / batch,
                      flops_per_step=flops, mfu=mfu,
                      peak_memory_gib=_util.peak_memory_gib(device))

    if args.bisect_json:
        with open(args.bisect_json) as f:
            bis = json.load(f)
        record["stage_ms"] = bis.get("stage_ms", bis)
        record["stage_ms_config"] = {k: bis[k] for k in ("batch", "db")
                                     if k in bis}

    if not args.skip_host_legs:
        # distinct uint8 pixels per batch, on the host
        host_pool = [q8.roll(i + 1, dims=0).numpy()
                     for i in range(args.host_iters)]
        svc.query(host_pool[0], model_norm, 0)["pose"].cpu()     # warm
        t0 = time.perf_counter()
        for i, q in enumerate(host_pool):
            svc.query(q, model_norm, i)["pose"].cpu()
        dt_sync = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_out = sum(1 for _ in svc.query_stream(host_pool, model_norm,
                                                depth=2))
        dt_pipe = time.perf_counter() - t0
        assert n_out == len(host_pool)
        n = batch * len(host_pool)
        print(f"host uint8, per-batch sync: {n / dt_sync:.0f} queries/s; "
              f"pipelined depth=2: {n / dt_pipe:.0f} queries/s "
              f"({dt_sync / dt_pipe:.2f}x over sync)", flush=True)
        record.update(host_sync_qps=n / dt_sync,
                      host_pipelined_qps=n / dt_pipe)

    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
