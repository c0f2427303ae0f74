"""Relocalization service entry point: `python -m
relpose_gnn_tpu_torch.cli.serve --scene <scene> [<scene> ...]`.

Port of the JAX package's `cli/serve.py`: builds the database on the card
(NetVLAD descriptors, backbone embeddings and poses of a scene's train
split, or `--load-db`), then serves the scene's query split through
`evaluation/service.py::RelocalizationService` (retrieval, neighbour
subsample, cached-embedding graph, GNN through the attention kernel,
absolute pose) with `--pipeline-depth` batches in flight, and reports the
per-scene median errors.  Several scenes serve through one
`evaluation/multiscene.py::MultiSceneService`, each with its own
normalisation.  Frames decode and resize on the host with the port's own
PNG library; query batches go to the card as uint8.

The same flags as the JAX script, plus `--device`.  `--weights` takes a
`.pth.tar` (the reference layout, loaded with strict=True) or a
checkpoint directory of `cli.train`; `--netvlad-checkpoint` the released
`netvlad_vgg16.tar`.  `--trace-dir DIR` records a `torch.profiler` trace
(CPU and CUDA activity) of the serving loop into DIR
(`utils/profiling.py::trace`), around the loops the JAX script traces:
the single-scene query stream and the multi-scene loop; the service's
spans (`relpose.service.*`, `relpose.stream.fetch`) are in it.  There is
no compiled query program, so no compile count is printed.

In stochastic mode the served-queries line ends with "window fallbacks f
of n batches": of the n batches that took the windowed selection
(`retrieval/subsample.py::WINDOW_CALLS`; none where the database holds no
more frames than the window), the f whose window could not fill the graph
and that fell back to the full sort (`WINDOW_FALLBACKS`).

`--mesh-data N` serves ONE scene over N processes, one per device (the
multi-process flags of cli/__init__.py): every process builds the same
database, `replicate_over` keeps it whole on every rank, each query batch
(whose size N must divide) splits over the ranks, and every rank reads
back the whole result; one batch in flight, with the same seed for every
batch, as the JAX script's mesh loop does.

    python -m relpose_gnn_tpu_torch.cli.serve --dataset 7Scenes \\
        --scene chess --data-path /data/7Scenes \\
        --weights epoch_199.pth.tar \\
        --netvlad-checkpoint netvlad_vgg16.tar --batch-size 64
"""

from __future__ import annotations

import argparse
import os.path as osp
import sys
import time

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.cli import (add_device_arg, end_processes,
                                       netvlad_encoder, pin_full_fp32,
                                       refuse_unported, start_processes)
from relpose_gnn_tpu_torch.data.cambridge import (CambridgeLandmark,
                                                  load_pose_stats)
from relpose_gnn_tpu_torch.data.graph_builder import _fit
from relpose_gnn_tpu_torch.data.seven_scenes import (SevenScenes,
                                                     load_scene_stats)
from relpose_gnn_tpu_torch.evaluation.evaluator import compute_pose_errors
from relpose_gnn_tpu_torch.evaluation.multiscene import MultiSceneService
from relpose_gnn_tpu_torch.evaluation.service import (RelocalizationService,
                                                      ServiceConfig)
from relpose_gnn_tpu_torch.parallel.mesh import create_mesh
from relpose_gnn_tpu_torch.parallel.multihost import process_count
from relpose_gnn_tpu_torch.retrieval import subsample
from relpose_gnn_tpu_torch.training import checkpoints as ckpt
from relpose_gnn_tpu_torch.training.experiment import (ExperimentConfig,
                                                       build_model,
                                                       load_database_images)
from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                    create_train_state)
from relpose_gnn_tpu_torch.utils.profiling import trace


def parse_args(argv):
    p = argparse.ArgumentParser("relpose_gnn_tpu serve")
    p.add_argument("--dataset", default="7Scenes",
                   choices=("7Scenes", "Cambridge"))
    p.add_argument("--scene", required=True, nargs="+",
                   help="one scene, or several (MultiSceneService)")
    p.add_argument("--data-path", required=True, help="raw dataset root")
    p.add_argument("--weights", default="",
                   help=".pth.tar or a checkpoint directory of cli.train; "
                        "empty = seeded random weights (smoke only)")
    p.add_argument("--netvlad-checkpoint", default="",
                   help="netvlad_vgg16.tar; empty = seeded random weights "
                        "(retrieval quality will be meaningless)")
    p.add_argument("--pose-stat-path", type=str, default="",
                   help="Cambridge translation stats file (without it "
                        "translations stay raw metres)")
    p.add_argument("--stats-path", default=None,
                   help="7-Scenes per-scene stats dir (default: bundled)")
    p.add_argument("--model-name", default="R3")
    p.add_argument("--backbone", default="resnet34")
    p.add_argument("--feat-dim", type=int, default=0)
    p.add_argument("--seq-len", type=int, default=8)
    p.add_argument("--sampling-period", type=int, default=None,
                   help="default: 5 (7-Scenes) / 3 (Cambridge)")
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--deterministic", action="store_true",
                   help="plain strided top-k (no stochastic drop/offset)")
    p.add_argument("--no-fold-bn", action="store_true")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--out", default=None, help="npz output for poses")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--retrieval-hw", type=int, nargs=2, default=(192, 256),
                   metavar=("H", "W"),
                   help="NetVLAD input size (smoke tests use smaller)")
    p.add_argument("--retrieval-mode", default="netvlad",
                   choices=("netvlad", "shared-trunk"),
                   help="'netvlad': the reference protocol; 'shared-trunk':"
                        " rank neighbours by cosine over the backbone "
                        "embeddings (a semantic knob: neighbour sets "
                        "change)")
    p.add_argument("--rank-dtype", default="float32",
                   choices=("float32", "bfloat16"),
                   help="descriptor-table dtype for the ranking (bfloat16: "
                        "half the table; a semantic knob, near-ties flip)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="query batches kept in flight (query_stream)")
    p.add_argument("--netvlad-clusters", type=int, default=64,
                   help="NetVLAD clusters (reference: 64)")
    p.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the serving loop "
                        "(TensorBoard / Perfetto)")
    p.add_argument("--capacity", type=int, default=None,
                   help="pre-allocate the database to this many frames "
                        "(RelocalizationService.add_frames grows into it)")
    p.add_argument("--save-db", default=None, metavar="NPZ",
                   help="persist the built database after building")
    p.add_argument("--load-db", default=None, metavar="NPZ",
                   help="restore a --save-db snapshot instead of embedding "
                        "the training split (config must match)")
    p.add_argument("--coordinator", type=str, default="",
                   help="host:port of process 0 (enables multi-process)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--local-device-count", type=int, default=0,
                   help="the JAX package's virtual devices per process; "
                        "refused above 1 (launch that many processes)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help=">0: split query batches over this many GLOBAL "
                        "ranks; --batch-size must divide it")
    add_device_arg(p)
    return p.parse_args(argv)


def _load_split(args, scene: str, train: bool):
    if args.dataset == "7Scenes":
        return SevenScenes(scene, args.data_path, train=train,
                           image_size=args.image_size)
    if not args.pose_stat_path:
        print("WARNING: Cambridge without --pose-stat-path: translations "
              "stay raw meters (checkpoints trained on normalized "
              "translations will NOT relocalize correctly)")
    return CambridgeLandmark(scene, args.data_path, train=train,
                             image_size=args.image_size,
                             pose_stats_file=args.pose_stat_path or None,
                             normalize_translation=bool(args.pose_stat_path),
                             normalize_images=False)


def _scene_stats(args, scene: str):
    """Per-scene pixel normalisation (7-Scenes stats.txt values;
    Cambridge's fixed Normalize(0.5, 0.25))."""
    if args.dataset == "7Scenes":
        return load_scene_stats(args.stats_path, scene)
    return np.full(3, 0.5, np.float32), np.full(3, 0.25, np.float32)


def _make_query_batches(q, args, h: int, w: int):
    """A uint8 query batch generator over a query split, and the list of
    the frame index each served row came from (a corrupt frame is
    replaced by the next readable one, the reference's skip-forward rule).
    Every batch has the full --batch-size rows: a ragged tail repeats its
    last frame, and callers trim outputs to `len(src_indices)`."""
    src_indices: list[int] = []

    def _load_skip_forward(idx):
        j = idx
        while j < len(q):
            img = q.load_image(j)
            if img is not None:
                return j, img
            j += 1
        j = idx - 1  # tail corruption: scan backward
        while j >= 0:
            img = q.load_image(j)
            if img is not None:
                return j, img
            j -= 1
        raise ValueError("query split has no readable frames")

    def gen():
        for i in range(0, len(q), args.batch_size):
            n = min(args.batch_size, len(q) - i)
            batch = np.zeros((args.batch_size, h, w, 3), np.uint8)
            for j in range(n):
                src, img = _load_skip_forward(i + j)
                src_indices.append(src)
                # the packed stores' quantisation, floor(x * 255 + 0.5)
                batch[j] = np.clip(_fit(img, h, w) * 255.0 + 0.5,
                                   0, 255).astype(np.uint8)
            batch[n:] = batch[n - 1]
            yield batch

    return gen, src_indices


def _load_model(args, device: torch.device, hw: tuple[int, int]):
    """The pose model, seeded from --seed, with --weights loaded; a ViT
    backbone's position table is built for the serving size `hw`."""
    ecfg = ExperimentConfig(dataset=args.dataset, model_name=args.model_name,
                            backbone=args.backbone, feat_dim=args.feat_dim,
                            seq_len=args.seq_len, knn=args.seq_len // 2,
                            droprate=0.0, dtype=args.dtype, seed=args.seed)
    model = build_model(ecfg, device, hw)
    if args.weights:
        if osp.isdir(args.weights):
            ckpt.restore_checkpoint(args.weights,
                                    create_train_state(model,
                                                       TrainerConfig()))
        else:
            model.load_state_dict(ckpt.read_state_dict(args.weights),
                                  strict=True)
        print(f"loaded model weights: {args.weights}")
    else:
        print("WARNING: random model weights (smoke mode)")
    return model.eval()


def main(argv=None):
    """Serve; returns the PoseErrors of the one scene, or {scene:
    PoseErrors} for several."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    pin_full_fp32()
    refuse_unported(args)
    started = start_processes(args)
    try:
        return _run(args)
    finally:
        end_processes(started)


def _run(args):
    mesh = None
    if args.mesh_data > 0:
        if len(args.scene) > 1:
            raise SystemExit("--mesh-data serves ONE scene (serving several "
                             "scenes over a mesh is not in the JAX package "
                             "either); pass a single --scene")
        if args.batch_size % args.mesh_data != 0:
            raise ValueError(f"--batch-size {args.batch_size} must divide "
                             f"--mesh-data {args.mesh_data}")
        mesh = create_mesh(n_data=args.mesh_data, n_model=1)
    device = resolve_device(args.device)
    h = args.image_size
    # serve at the aspect the graph builder stores: 7-Scenes 640x480
    # (4:3 -> 256x341), Cambridge 1920x1080 (16:9 -> 256x455)
    aspect = 4 / 3 if args.dataset == "7Scenes" else 16 / 9
    w = int(round(h * aspect))
    model = _load_model(args, device, (h, w))
    rhw = tuple(args.retrieval_hw)

    netvlad = None
    if args.retrieval_mode == "shared-trunk":
        if args.netvlad_checkpoint:
            print("NOTE: --netvlad-checkpoint is unused with "
                  "--retrieval-mode shared-trunk")
    else:
        netvlad = netvlad_encoder(
            args.netvlad_checkpoint, args.netvlad_clusters,
            torch.bfloat16 if args.dtype == "bfloat16" else None,
            seed=args.seed + 1)
        print(f"loaded NetVLAD: {args.netvlad_checkpoint}"
              if args.netvlad_checkpoint
              else "WARNING: random NetVLAD weights (smoke mode)")

    sp = args.sampling_period or (3 if args.dataset == "Cambridge" else 5)
    if len(args.scene) > 1:
        return _serve_multiscene(args, model, netvlad, h, w, rhw, sp, device)

    scene = args.scene[0]
    mean, std = (torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in _scene_stats(args, scene))

    def model_norm(x01):
        return (x01 - mean) / std

    svc = RelocalizationService(
        model, netvlad,
        ServiceConfig(seq_len=args.seq_len, sampling_period=sp,
                      retrieval_hw=rhw, deterministic=args.deterministic,
                      capacity=args.capacity, retrieval=args.retrieval_mode,
                      rank_dtype=args.rank_dtype),
        fold_bn=not args.no_fold_bn, device=device)
    t0 = time.perf_counter()
    if args.load_db:
        svc.load_database(args.load_db)
        print(f"database restored from {args.load_db} ({svc.db_count} "
              f"frames, {time.perf_counter() - t0:.1f}s; no re-embedding)")
    else:
        db = _load_split(args, scene, train=True)
        print(f"building database: {len(db)} frames ...")
        imgs = load_database_images(db, h, w)
        t0 = time.perf_counter()
        svc.build(imgs, db.poses, model_norm, batch=args.batch_size)
        _sync(device)
        print(f"database built in {time.perf_counter() - t0:.1f}s")
    if mesh is not None:   # before a save: then rank 0 alone writes
        svc.replicate_over(mesh)
    if args.save_db:
        svc.save_database(args.save_db)
        print(f"database saved to {args.save_db}")

    q = _load_split(args, scene, train=False)
    print(f"serving {len(q)} queries (batch {args.batch_size}, pipeline "
          f"depth {args.pipeline_depth}) ...")
    query_batches, src_indices = _make_query_batches(q, args, h, w)
    windows = _window_counts()
    t0 = time.perf_counter()
    if mesh is None:
        with trace(args.trace_dir):
            poses_out = [out["pose"] for out in svc.query_stream(
                query_batches(), model_norm, depth=args.pipeline_depth,
                rng=args.seed)]
    else:
        print(f"mesh serving: data={args.mesh_data} across "
              f"{process_count()} process(es)")
        poses_out = [svc.query(batch, model_norm, args.seed)["pose"]
                     .cpu().numpy() for batch in query_batches()]
    t_serve = time.perf_counter() - t0
    # trim the tail padding (see _make_query_batches)
    poses_out = np.concatenate(poses_out)[:len(src_indices)]
    print(f"served {len(poses_out)} queries in {t_serve:.2f}s "
          f"({len(poses_out) / max(t_serve, 1e-9):.0f} q/s incl. retrieval "
          "AND host image decode, pipelined)"
          f"{_fallbacks(svc.cfg, windows)}")
    return _report_scene(args, q, poses_out, src_indices, args.out)


def _window_counts() -> tuple[int, int]:
    return subsample.WINDOW_CALLS, subsample.WINDOW_FALLBACKS


def _fallbacks(cfg: ServiceConfig, before: tuple[int, int]) -> str:
    """', window fallbacks f of n batches' since `before` (a
    `_window_counts()`) in stochastic mode, '' in deterministic mode."""
    if cfg.deterministic:
        return ""
    calls, falls = (a - b for a, b in zip(_window_counts(), before))
    return f", window fallbacks {falls} of {calls} batches"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _report_scene(args, q, poses_out, src_indices, out_path):
    """Per-scene error report and the optional npz export."""
    pose_mean = pose_std = None
    if args.dataset == "Cambridge" and args.pose_stat_path:
        pose_mean, pose_std = load_pose_stats(args.pose_stat_path)
    targ = q.poses[np.asarray(src_indices[:len(poses_out)])]
    err = compute_pose_errors(poses_out, targ,
                              pose_mean=pose_mean, pose_std=pose_std)
    print(err)
    if out_path:
        np.savez(out_path, pose6=poses_out,
                 abs_t=err.pred_poses[:, :3], abs_q=err.pred_poses[:, 3:],
                 targ_t=err.targ_poses[:, :3], targ_q=err.targ_poses[:, 3:])
        print(f"wrote {out_path}")
    return err


def _serve_multiscene(args, model, netvlad, h, w, rhw, sp, device):
    """Serve several scenes through one MultiSceneService: the tables of
    every scene share one capacity, and each scene's normalisation rides
    with its tables."""
    scenes = args.scene
    databases = {}
    capacity = args.capacity
    if not args.load_db:
        databases = {s: _load_split(args, s, train=True) for s in scenes}
        if capacity is None:
            capacity = max(len(db) for db in databases.values())
    elif capacity is None:
        raise SystemExit("--load-db with several scenes needs --capacity "
                         "(array sizes are baked into the snapshot)")

    ms = MultiSceneService(
        model, netvlad,
        ServiceConfig(seq_len=args.seq_len, sampling_period=sp,
                      retrieval_hw=rhw, deterministic=args.deterministic,
                      capacity=capacity, retrieval=args.retrieval_mode,
                      rank_dtype=args.rank_dtype),
        fold_bn=not args.no_fold_bn, device=device)
    if args.load_db:
        t0 = time.perf_counter()
        ms.load_database(args.load_db)
        missing = [s for s in scenes if s not in ms.scenes()]
        if missing:
            # fail before serving: an error mid-run would throw away every
            # earlier scene's results
            raise SystemExit(
                f"--load-db snapshot {args.load_db} has no database for "
                f"scene(s) {missing}; it holds {ms.scenes()}")
        print(f"databases restored from {args.load_db} "
              f"({', '.join(ms.scenes())}; "
              f"{time.perf_counter() - t0:.1f}s, no re-embedding)")
    else:
        for s in scenes:
            db = databases[s]
            print(f"[{s}] building database: {len(db)} frames "
                  f"(capacity {capacity}) ...")
            imgs = load_database_images(db, h, w)
            mean, std = _scene_stats(args, s)
            t0 = time.perf_counter()
            ms.add_scene(s, imgs, db.poses, mean, std,
                         batch=args.batch_size)
            _sync(device)
            print(f"[{s}] built in {time.perf_counter() - t0:.1f}s")
    if args.save_db:
        ms.save_database(args.save_db)
        print(f"databases saved to {args.save_db}")

    results = {}
    with trace(args.trace_dir):
        for s in scenes:
            q = _load_split(args, s, train=False)
            print(f"[{s}] serving {len(q)} queries (batch "
                  f"{args.batch_size}) ...")
            query_batches, src_indices = _make_query_batches(q, args, h, w)
            windows = _window_counts()
            t0 = time.perf_counter()
            poses_out = [out["pose"] for out in ms.query_stream(
                s, query_batches(), depth=args.pipeline_depth,
                rng=args.seed)]
            t_serve = time.perf_counter() - t0
            poses_out = np.concatenate(poses_out)[:len(src_indices)]
            print(f"[{s}] served {len(poses_out)} queries in "
                  f"{t_serve:.2f}s "
                  f"({len(poses_out) / max(t_serve, 1e-9):.0f} q/s)"
                  f"{_fallbacks(ms.cfg, windows)}")
            out_path = (f"{args.out.rsplit('.npz', 1)[0]}_{s}.npz"
                        if args.out else None)
            results[s] = _report_scene(args, q, poses_out, src_indices,
                                       out_path)
    print(f"served {len(scenes)} scenes through one MultiSceneService "
          f"(capacity {capacity})")
    return results


if __name__ == "__main__":
    main()
