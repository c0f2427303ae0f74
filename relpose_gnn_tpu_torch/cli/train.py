"""Training entry point: `python -m relpose_gnn_tpu_torch.cli.train`.

Port of the JAX package's `cli/train.py` (the reference's
training/train.py:349-392 argparse surface): the same flags, defaults,
choices and `exp_name` scheme, plus `--device`; over several GPUs one
process per device (cli/__init__.py).  Builds the port's
`ExperimentConfig`, runs `training/experiment.py::run_training` on the
card (or where `--device` says) and prints each test scene's best
medians.  Checkpoints land in `<save-dir>/<dataset>/<train-scene>/
<exp-name>/ckpt/<epoch>/` (every `--ckpt-every` epochs, and at epochs
149 and 199); `cli.test --weights-filename` takes that `ckpt` directory.
"""

from __future__ import annotations

import argparse
import sys

from relpose_gnn_tpu_torch.cli import (add_device_arg, end_processes,
                                       pin_full_fp32, refuse_unported,
                                       start_processes)
from relpose_gnn_tpu_torch.training.experiment import (ExperimentConfig,
                                                       run_training)


def parse_args(argv):
    p = argparse.ArgumentParser("relpose_gnn_tpu train")
    p.add_argument("--experiment", type=int, default=0,
                   help="0 multi-scene, 1 leave-one-out, 2 single-scene")
    p.add_argument("--dataset", type=str, default="Cambridge",
                   choices=("7Scenes", "Cambridge"))
    p.add_argument("--train-scene", type=str, default="multi")
    p.add_argument("--test-scene", type=str, default="multi")
    p.add_argument("--train-data-dir", type=str, required=True)
    p.add_argument("--test-data-dir", type=str, required=True)
    p.add_argument("--save-dir", type=str, default="outputs")
    p.add_argument("--weights-filename", type=str, default="")
    p.add_argument("--pose-stat-path", type=str, default="")
    p.add_argument("--model-name", type=str, default="R3",
                   choices=("R1", "R2", "R3"))
    p.add_argument("--srq", type=float, default=-2.0)
    p.add_argument("--saq", type=float, default=-2.0)
    p.add_argument("--droprate", type=float, default=0.5)
    p.add_argument("--gnn-recursion", type=int, default=2)
    p.add_argument("--lambda-AP", dest="lambda_ap", type=float, default=0.0)
    p.add_argument("--max-epoch", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=8,
                   help="graph size; selects the <scene>_fc{N}_... stores")
    p.add_argument("--exp-name", default=None, type=str)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--knn", default=4, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--lr-decay-step", default=50, type=int)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--backbone", default="resnet34",
                   choices=("resnet34", "resnet18", "vit"),
                   help="node encoder (resnet34 = reference; vit = "
                        "stretch, ViT-B/16)")
    p.add_argument("--feat-dim", type=int, default=0,
                   help="override feat/edge/node dims (0 = preset default)")
    p.add_argument("--mesh-data", type=int, default=0,
                   help=">0: split each batch over this many ranks "
                        "(GLOBAL, one process per device)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel axis: the GNN MLPs split over "
                        "this many ranks")
    p.add_argument("--coordinator", type=str, default="",
                   help="host:port of process 0 (enables multi-process)")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--local-device-count", type=int, default=0,
                   help="the JAX package's virtual devices per process; "
                        "a torch process drives one device, so above 1 "
                        "it is refused: launch that many processes")
    p.add_argument("--eval-after-epoch", type=int, default=100,
                   help="in-loop per-scene eval for epochs > this "
                        "(reference: 100, train.py:421)")
    p.add_argument("--ckpt-every", type=int, default=0,
                   help="ALSO checkpoint every N epochs (0 = reference "
                        "cadence 149/199 only); pairs with --resume")
    p.add_argument("--device-cache", action="store_true",
                   help="hold the packed stores on the card and gather "
                        "batches there (bit for bit the host feed)")
    p.add_argument("--resume", action="store_true",
                   help="restore the latest full train state (weights, "
                        "optimizer moments, step) from the checkpoint dir "
                        "and continue at the next epoch, bit for bit")
    p.add_argument("--ckpt-dir", type=str, default="",
                   help="override <logdir>/ckpt")
    add_device_arg(p)
    args = p.parse_args(argv)
    if args.exp_name is None:  # naming scheme of train.py:384-390
        if args.experiment == 2:
            args.exp_name = (f"{args.dataset}_single_w_{args.train_scene}"
                             f"_w_test_{args.test_scene}_seed_{args.seed}")
        elif args.experiment == 1:
            args.exp_name = (f"{args.dataset}_multi_wo_{args.test_scene}"
                             f"_w_test_{args.test_scene}_seed_{args.seed}")
        else:
            args.exp_name = (f"{args.dataset}_multi_w_test_"
                             f"{args.test_scene}_seed_{args.seed}")
    return args


def main(argv=None) -> dict:
    """Train; returns run_training's {"state", "best"}."""
    args = parse_args(argv if argv is not None else sys.argv[1:])
    pin_full_fp32()
    refuse_unported(args)
    started = start_processes(args)
    try:
        out = _run(args)
    finally:
        end_processes(started)
    for scene, b in out["best"].items():
        print(f"{scene}: best median t {b['median_t']:.3f} m, "
              f"best median rot {b['median_q']:.2f} deg")
    return out


def _run(args) -> dict:
    cfg = ExperimentConfig(
        dataset=args.dataset, experiment=args.experiment,
        train_scene=args.train_scene, test_scene=args.test_scene,
        train_data_dir=args.train_data_dir,
        test_data_dir=args.test_data_dir, save_dir=args.save_dir,
        exp_name=args.exp_name, model_name=args.model_name,
        batch_size=args.batch_size, seq_len=args.seq_len,
        max_epoch=args.max_epoch,
        seed=args.seed, knn=args.knn, droprate=args.droprate,
        gnn_recursion=args.gnn_recursion, lr=args.lr,
        lr_decay_step=args.lr_decay_step, srq=args.srq, saq=args.saq,
        lambda_ap=args.lambda_ap, weights_filename=args.weights_filename,
        pose_stats_file=args.pose_stat_path, dtype=args.dtype,
        backbone=args.backbone, feat_dim=args.feat_dim,
        mesh_data=args.mesh_data, mesh_model=args.mesh_model,
        resume=args.resume, ckpt_dir=args.ckpt_dir,
        device_cache=args.device_cache, ckpt_every=args.ckpt_every,
        eval_after_epoch=args.eval_after_epoch)
    return run_training(cfg, device=args.device)


if __name__ == "__main__":
    main()
