"""Experiment orchestration: datasets, model, train and eval loops.

Port of `relpose_gnn_tpu/training/experiment.py` (reference
training/train.py:349-458, testing/test.py:289-353).  Scene lists follow
train.py:87-106 (experiment 0 = multi-scene, 1 = leave-one-out,
2 = single scene); stores follow the `<scene>_fc8_sp{5|3}_{train|test}`
layout (train.py:115-127) as packed arrays (data/packed.py).

`run_training` and `run_eval` run on `device`: None means the CUDA card
(they raise where there is none), "cpu" is an explicit request.  The
training feed, as in the JAX package:
  * `device_cache=True`: every store uploaded once and batches gathered
    on the device (`data/device_cache.py::DeviceCachedFeed`), for the
    training epochs and the evals;
  * else the native graphio runtime (`data/native_io.py::
    NativeConcatDataset`) where it builds, else the numpy memmaps, through
    `data_iterator` + `device_prefetch`; the log says which.
`run_eval(serving_data_path=...)` reads the scene's raw training frames
with the 7-Scenes / Cambridge loaders (PIL decode).  `mesh_data > 0`
raises NotImplementedError naming its ROADMAP.md queue (multi-GPU); the
JAX package's compile cache is dropped (a TPU workaround).
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp
from pathlib import Path

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.data import native_io
from relpose_gnn_tpu_torch.data.cambridge import (CAMBRIDGE_SCENES,
                                                  CambridgeLandmark)
from relpose_gnn_tpu_torch.data.device_cache import DeviceCachedFeed
from relpose_gnn_tpu_torch.data.graph_builder import _fit
from relpose_gnn_tpu_torch.data.packed import (ConcatPackedDataset,
                                               PackedGraphDataset)
from relpose_gnn_tpu_torch.data.pipeline import data_iterator, device_prefetch
from relpose_gnn_tpu_torch.data.seven_scenes import SEVEN_SCENES, SevenScenes
from relpose_gnn_tpu_torch.evaluation.evaluator import (compute_pose_errors,
                                                        evaluate_dataset,
                                                        save_poses)
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.ops import graph as graph_ops
from relpose_gnn_tpu_torch.training import checkpoints as ckpt
from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                    create_train_state,
                                                    make_eval_step,
                                                    make_train_step)
from relpose_gnn_tpu_torch.utils.logging import MetricsWriter, get_logger


@dataclasses.dataclass
class ExperimentConfig:
    """The JAX ExperimentConfig's fields and defaults (train.py's CLI)."""

    dataset: str = "7Scenes"           # '7Scenes' | 'Cambridge'
    experiment: int = 0                # 0 multi, 1 leave-one-out, 2 single
    train_scene: str = "multi"
    test_scene: str = "multi"
    train_data_dir: str = ""
    test_data_dir: str = ""
    save_dir: str = "outputs"
    exp_name: str = "exp"
    model_name: str = "R3"
    batch_size: int = 8
    seq_len: int = 8
    max_epoch: int = 200
    eval_after_epoch: int = 100
    ckpt_epochs: tuple = (149, 199)
    ckpt_every: int = 0                # also checkpoint every N epochs
    seed: int = 0
    knn: int = 4
    droprate: float = 0.5
    gnn_recursion: int = 2
    lr: float = 1e-4
    lr_decay_step: int = 50
    srq: float = -2.0
    saq: float = -2.0
    lambda_ap: float = 0.0
    weights_filename: str = ""
    allow_random_init: bool = False    # run_eval: permit missing weights
    pose_stats_file: str = ""          # Cambridge translation stats
    dtype: str = "bfloat16"
    backbone: str = "resnet34"
    feat_dim: int = 0                  # 0 = the preset's
    recover_nonfinite: bool = True     # roll back a non-finite epoch
    mesh_data: int = 0                 # > 0: multi-GPU (not ported yet)
    mesh_model: int = 1
    resume: bool = False               # continue from the latest checkpoint
    ckpt_dir: str = ""                 # default <logdir>/ckpt
    eval_fuse: str = "first"           # 'first' | 'mean' | 'median'
    serving_compact_edges: bool = True  # cached-serving eval on edge lists
    device_cache: bool = False         # stores held on the device


def _refuse_unported(cfg: ExperimentConfig) -> None:
    if cfg.mesh_data > 0:
        raise NotImplementedError(
            "mesh_data > 0 (training over several cards) is in ROADMAP.md, "
            "'Modules to port', the multi-GPU slice")


def static_anchor_for(cfg: ExperimentConfig) -> int | None:
    """Anchor rule (testing/test.py:227-229): a dynamic kNN graph takes the
    nearest pre-GNN neighbour (None); the static fc graph (knn=0) the
    first edge into node 0 in construction order."""
    if cfg.knn != 0:
        return None
    return graph_ops.first_edge_anchor(graph_ops.fc_edge_index(cfg.seq_len))


def scene_lists(cfg: ExperimentConfig) -> tuple[list[str], list[str]]:
    """(training scenes, test scenes) per train.py:87-106."""
    all_scenes = list(SEVEN_SCENES if cfg.dataset == "7Scenes"
                      else CAMBRIDGE_SCENES)
    if cfg.experiment in (0, 1):
        train_scenes = list(all_scenes)
        if cfg.experiment == 1:
            train_scenes.remove(cfg.test_scene)
    else:
        train_scenes = [cfg.train_scene]
    test_scenes = (all_scenes if cfg.test_scene == "multi"
                   else [cfg.test_scene])
    return train_scenes, test_scenes


def dataset_root(data_dir: str, scene: str, dataset: str, split: str,
                 seq_len: int = 8) -> str:
    """`<scene>_fc{N}_sp{5|3}_{split}` (train.py:112-127, keyed on
    seq_len so that builder and trainer agree)."""
    sp = 3 if dataset == "Cambridge" else 5
    return osp.join(data_dir, f"{scene}_fc{seq_len}_sp{sp}_{split}")


def load_test_datasets(cfg: ExperimentConfig) -> dict:
    return {s: PackedGraphDataset(
        dataset_root(cfg.test_data_dir, s, cfg.dataset, "test", cfg.seq_len))
        for s in scene_lists(cfg)[1]}


def load_datasets(cfg: ExperimentConfig):
    train_ds = ConcatPackedDataset([
        PackedGraphDataset(dataset_root(cfg.train_data_dir, s, cfg.dataset,
                                        "train", cfg.seq_len))
        for s in scene_lists(cfg)[0]])
    return train_ds, load_test_datasets(cfg)


def build_model(cfg: ExperimentConfig,
                device: torch.device | str | None = None) -> RelPoseGNN:
    """The preset (R1/R2/R3, else R3) with the experiment's overrides, on
    `device` (None: the card), weights drawn from `cfg.seed`."""
    device = resolve_device(device)
    overrides = dict(num_nodes=cfg.seq_len, knn=cfg.knn,
                     droprate=cfg.droprate, gnn_recursion=cfg.gnn_recursion,
                     dtype=torch.bfloat16 if cfg.dtype == "bfloat16"
                     else None, backbone=cfg.backbone)
    if cfg.feat_dim:
        overrides.update(feat_dim=cfg.feat_dim, edge_dim=cfg.feat_dim,
                         node_dim=cfg.feat_dim)
    mcfg = RelPoseGNNConfig.preset(
        cfg.model_name if cfg.model_name in ("R1", "R2", "R3") else "R3",
        **overrides)
    with torch.device(device):
        model = RelPoseGNN(mcfg)
    init_weights(model, torch.Generator(device=device).manual_seed(cfg.seed))
    return model


def pose_stats(cfg: ExperimentConfig):
    if cfg.dataset == "Cambridge" and cfg.pose_stats_file:
        mean_t, std_t = np.loadtxt(cfg.pose_stats_file)
        return np.asarray(mean_t), np.asarray(std_t)
    return np.zeros(3), np.ones(3)  # train.py:140-144


def evaluate_scene(eval_step, state, ds: PackedGraphDataset, batch_size: int,
                   mean_t, std_t, device: torch.device,
                   cached: DeviceCachedFeed | None = None):
    """Batched whole-scene eval in store order, from the store held on the
    device where `cached` is given, else through the host feed."""
    if cached is not None:
        batches = (b for b, _ in cached.eval_batches(batch_size))
    else:
        it = data_iterator(ds, batch_size=batch_size, shuffle=False,
                           epochs=1, drop_remainder=False)
        batches = device_prefetch(it, ds.mean, ds.std, device)
    return evaluate_dataset(eval_step, state, batches, mean_t, std_t)


def _trainer_config(cfg: ExperimentConfig, steps_per_epoch: int = 1000
                    ) -> TrainerConfig:
    return TrainerConfig(lr=cfg.lr, lr_decay_step=cfg.lr_decay_step,
                         saq=cfg.saq, srq=cfg.srq, lambda_ap=cfg.lambda_ap,
                         steps_per_epoch=steps_per_epoch)


def run_training(cfg: ExperimentConfig,
                 device: torch.device | str | None = None) -> dict:
    """Train per the experiment; returns {"state", "best"} (best median
    errors per test scene over the evaluated epochs)."""
    _refuse_unported(cfg)
    device = resolve_device(device)
    logdir = Path(cfg.save_dir) / cfg.dataset / cfg.train_scene / cfg.exp_name
    logger = get_logger(logfile=str(logdir / "logger.log"))
    metrics_out = MetricsWriter(str(logdir / "metrics.jsonl"))

    train_ds, test_ds = load_datasets(cfg)
    cached_train = cached_test = None
    train_feed = train_ds
    if cfg.device_cache:
        cached_train = DeviceCachedFeed(train_ds, device)
        cached_test = {s: DeviceCachedFeed(d, device)
                       for s, d in test_ds.items()}
        logger.info("training feed: device cache, train %.2f GiB + test "
                    "%.2f GiB on %s", cached_train.nbytes / 2**30,
                    sum(c.nbytes for c in cached_test.values()) / 2**30,
                    device)
    elif native_io.available():
        roots = [dataset_root(cfg.train_data_dir, s, cfg.dataset, "train",
                              cfg.seq_len) for s in scene_lists(cfg)[0]]
        # gather threads sized to the host, one core left to the step
        train_feed = native_io.NativeConcatDataset(
            roots, threads=max(1, min(4, (os.cpu_count() or 1) - 1)))
        logger.info("training feed: native C++ graphio")
    else:
        logger.info("training feed: numpy memmaps (native graphio does "
                    "not build here)")
    # a dataset smaller than the batch would yield no batch at all
    batch_size = min(cfg.batch_size, max(1, len(train_ds)))
    if batch_size < cfg.batch_size:
        logger.warning("dataset has %d graphs < batch_size %d; clamping "
                       "batch to %d", len(train_ds), cfg.batch_size,
                       batch_size)
    tcfg = _trainer_config(cfg, max(1, len(train_ds) // batch_size))
    state = create_train_state(build_model(cfg, device), tcfg)
    if cfg.weights_filename and osp.isfile(cfg.weights_filename):
        ckpt.load_torch_weights(state, cfg.weights_filename)
        logger.info("Loaded weights from %s", cfg.weights_filename)

    start_epoch = 0
    if cfg.resume:
        ckdir = cfg.ckpt_dir or str(logdir / "ckpt")
        last = ckpt.latest_epoch(ckdir)
        if last is not None:
            ckpt.restore_checkpoint(ckdir, state, last)
            start_epoch = last + 1
            logger.info("resumed full train state from %s (epoch %d)",
                        ckdir, last)
        else:
            logger.info("resume requested but no checkpoint under %s; "
                        "starting fresh", ckdir)

    best = {s: {"median_t": 1e6, "median_q": 1e6} for s in test_ds}
    if start_epoch > 0:
        _fold_best_from_metrics(metrics_out.path, best)
    try:
        return _training_loop(cfg, tcfg, logger, metrics_out, train_feed,
                              test_ds, batch_size, state, best, logdir,
                              device, start_epoch, cached_train, cached_test)
    finally:
        if train_feed is not train_ds:
            train_feed.close()


def _fold_best_from_metrics(path: str, best: dict) -> None:
    """Fold per-scene eval medians of a prior run's metrics.jsonl into
    `best` (in place); a missing file and other records are skipped."""
    if not osp.isfile(path):
        return
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            s = rec.get("scene")
            if s in best:
                for key in ("median_t", "median_q"):
                    if isinstance(rec.get(key), float):
                        best[s][key] = min(best[s][key], rec[key])


def _training_loop(cfg, tcfg, logger, metrics_out, train_feed, test_ds,
                   batch_size, state, best, logdir, device,
                   start_epoch: int = 0, cached_train=None,
                   cached_test=None) -> dict:
    train_step = make_train_step(tcfg)
    eval_step = make_eval_step(ref_node=0,
                               static_anchor=static_anchor_for(cfg))
    mean_t, std_t = pose_stats(cfg)
    for epoch in range(start_epoch, cfg.max_epoch):
        if cfg.recover_nonfinite:
            epoch_start = state.state_dict()
        if cached_train is not None:
            batches = cached_train.epoch(seed=cfg.seed + epoch,
                                         batch_size=batch_size)
        else:
            it = data_iterator(train_feed, batch_size=batch_size,
                               seed=cfg.seed + epoch, epochs=1)
            batches = device_prefetch(it, train_feed.mean, train_feed.std,
                                      device)
        m = None
        # OR-accumulated on the device over every step (a transient inf
        # mid-epoch must roll back even if later steps recover); read once
        nonfinite = torch.zeros((), dtype=torch.bool, device=device)
        for batch in batches:
            m = train_step(state, batch, cfg.seed)
            nonfinite |= ~torch.isfinite(m["loss"])
        if m is None:
            logger.warning("[epoch %04d] iterator yielded no batches; "
                           "skipping epoch", epoch)
            continue
        if cfg.recover_nonfinite and bool(nonfinite):
            logger.warning("[epoch %04d] non-finite loss encountered; "
                           "rolling the epoch back", epoch)
            step = state.step
            state.load_state_dict(epoch_start)
            state.step = step
            continue
        metrics_out.write(state.step, m, epoch=epoch)
        logger.info("[epoch %04d] loss=%.4f t=%.4f q=%.4f", epoch,
                    float(m["loss"]), float(m["t_loss"]),
                    float(m["q_loss"]))
        if epoch in cfg.ckpt_epochs or (
                cfg.ckpt_every and (epoch + 1) % cfg.ckpt_every == 0):
            ckpt.save_checkpoint(cfg.ckpt_dir or str(logdir / "ckpt"),
                                 state, epoch,
                                 max_to_keep=(10_000 if cfg.ckpt_every
                                              else 5))
        if epoch > cfg.eval_after_epoch:
            for s, ds in test_ds.items():
                err = evaluate_scene(eval_step, state, ds, cfg.batch_size,
                                     mean_t, std_t, device,
                                     cached=(cached_test or {}).get(s))
                logger.info("[scene %s epoch %04d] %s", s, epoch, err)
                metrics_out.write(state.step,
                                  {"median_t": err.median_t,
                                   "median_q": err.median_q},
                                  epoch=epoch, scene=s)
                best[s]["median_t"] = min(best[s]["median_t"], err.median_t)
                best[s]["median_q"] = min(best[s]["median_q"], err.median_q)
    return {"state": state, "best": best}


def run_eval(cfg: ExperimentConfig, weights: str | None = None,
             save_predictions: bool = True,
             serving_data_path: str | None = None,
             device: torch.device | str | None = None) -> dict:
    """Evaluate per test scene -> {scene: PoseErrors}.  `weights`: a
    reference `.pth`/`.pth.tar`/`.tar` file, or a checkpoint directory of
    `save_checkpoint` (its latest epoch).  With `serving_data_path` (the
    raw dataset root) and stores that carry nbr_idx, the cached-embedding
    serving path answers (evaluation/serving.py)."""
    _refuse_unported(cfg)
    device = resolve_device(device)
    logdir = Path(cfg.save_dir) / cfg.dataset / cfg.test_scene / cfg.exp_name
    logger = get_logger(logfile=str(logdir / "eval.log"))
    test_ds = load_test_datasets(cfg)
    state = create_train_state(build_model(cfg, device), _trainer_config(cfg))
    weights = weights or cfg.weights_filename
    if weights:
        if osp.isfile(weights) and weights.endswith(
                (".pth", ".pth.tar", ".tar")):
            ckpt.load_torch_weights(state, weights)
        elif osp.isdir(weights):
            ckpt.restore_checkpoint(weights, state)
        elif cfg.allow_random_init:
            logger.warning(
                "weights path %s does not exist; evaluating RANDOM INIT "
                "weights (smoke mode, allow_random_init)", weights)
        else:
            raise FileNotFoundError(
                f"weights path {weights!r} does not exist (pass "
                "allow_random_init to evaluate random-init weights as a "
                "smoke test)")
        if osp.exists(weights):
            logger.info("Loaded weights from %s", weights)
    elif not cfg.allow_random_init:
        raise ValueError("run_eval called with no weights; pass "
                         "allow_random_init to evaluate random-init weights")

    eval_step = make_eval_step(ref_node=0, fuse=cfg.eval_fuse,
                               static_anchor=static_anchor_for(cfg))
    mean_t, std_t = pose_stats(cfg)
    results = {}
    for s, ds in test_ds.items():
        if serving_data_path is not None and ds.nbr_idx is not None:
            err = _evaluate_scene_serving(cfg, state.model, ds, s,
                                          serving_data_path, mean_t, std_t,
                                          device)
        else:
            err = evaluate_scene(eval_step, state, ds, cfg.batch_size,
                                 mean_t, std_t, device)
        logger.info("[scene %s] %s", s, err)
        if save_predictions:
            save_poses(str(logdir), s, err, rel_paths=ds.rel_paths)
        results[s] = err
    return results


def load_database_images(database, h: int, w: int) -> np.ndarray:
    """A database split as uint8 [M, H, W, 3] for serving eval.  A corrupt
    frame (`load_image` -> None) takes the next valid frame's pixels, the
    reference loaders' skip-forward rule."""
    imgs = np.zeros((len(database), h, w, 3), np.uint8)
    invalid = np.zeros(len(database), bool)
    for i in range(len(database)):
        img = database.load_image(i)
        if img is None:
            invalid[i] = True
        else:
            imgs[i] = np.clip(_fit(img, h, w) * 255.0 + 0.5, 0, 255)
    if invalid.any():
        valid_idx = np.flatnonzero(~invalid)
        if len(valid_idx) == 0:
            raise ValueError("database has no readable frames")
        bad = np.flatnonzero(invalid)
        pos = np.clip(np.searchsorted(valid_idx, bad), 0, len(valid_idx) - 1)
        imgs[bad] = imgs[valid_idx[pos]]
        get_logger().warning(
            "serving database: %d corrupt frame(s) substituted with the "
            "next valid frame (indices %s)", len(bad), bad[:10].tolist())
    return imgs


def _raw_database(cfg: ExperimentConfig, scene: str, root: str, h: int):
    """The scene's raw train split (`build_graphs`' neighbour
    source), raw [0, 1] pixels at the stores' size: the packed header's
    statistics normalise on the device."""
    if cfg.dataset == "7Scenes":
        return SevenScenes(scene, root, train=True, image_size=h)
    return CambridgeLandmark(
        scene, root, train=True, image_size=h,
        pose_stats_file=cfg.pose_stats_file or None,
        normalize_translation=bool(cfg.pose_stats_file),
        normalize_images=False)


def _evaluate_scene_serving(cfg: ExperimentConfig, model: RelPoseGNN, ds,
                            scene: str, raw_data_path: str, mean_t, std_t,
                            device: torch.device):
    """Cached-embedding serving over one scene: the database is the
    scene's train split, embedded once."""
    from relpose_gnn_tpu_torch.evaluation.serving import evaluate_scene_cached

    h, w = ds.meta["height"], ds.meta["width"]
    imgs = load_database_images(_raw_database(cfg, scene, raw_data_path, h),
                                h, w)
    if (cfg.serving_compact_edges and model.cfg.use_gnn
            and not model.cfg.compact_edges):
        # the compact edge-list GNN: the same math per edge, same weights
        compact = RelPoseGNN(dataclasses.replace(model.cfg,
                                                 compact_edges=True))
        compact.load_state_dict(model.state_dict(), strict=True)
        model = compact
    out = evaluate_scene_cached(model, ds, imgs, batch_size=cfg.batch_size,
                                static_anchor=static_anchor_for(cfg),
                                fuse=cfg.eval_fuse, device=device)
    return compute_pose_errors(out["pred"], out["target"],
                               pose_mean=mean_t, pose_std=std_t)
