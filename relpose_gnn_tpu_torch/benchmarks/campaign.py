"""Convergence campaign through the whole training protocol.

    python -m relpose_gnn_tpu_torch.benchmarks.campaign prepare --root R
    python -m relpose_gnn_tpu_torch.cli.train ...      (the `train` line)
    python -m relpose_gnn_tpu_torch.cli.test ...       (the `test` line)
    python -m relpose_gnn_tpu_torch.benchmarks.campaign report \
        --logdir R/out/7Scenes/multi/acc_r05 --eval-dir R/out

Counterpart of the JAX package's `benchmarks/campaign.py`.  The protocol
is the reference's: raw scenes -> `cli.build_graphs` -> `cli.train`
(the epoch loop, the per-scene eval after epoch 100, checkpoints) ->
`cli.test` -> npz exports, on the synthetic 7-Scenes generator
(`data/synthetic_scenes.py`), at the production config: R3 (ResNet34,
2048-dim GNN), 256x341 frames, fc8 graphs, batch 8, 200 epochs, the
reference's rate and its decay.  It shows whether this training stack
trains the flagship model to convergence end to end; medians on the real
scenes need the released datasets.

Subcommands:
  prepare  write the raw scenes and their stats, then build the train and
           test graph stores (RAND sampling) with `cli.build_graphs` in a
           subprocess: on the card unless `--device cpu` is given
  report   fold <logdir>/metrics.jsonl (and the npz exports under
           `--eval-dir`) into one JSON document: the loss by epoch, each
           scene's medians by epoch, the best and final medians, the
           config and the command lines that reproduce the run; written
           to `--out`, by default `<logdir>/acc_report.json`

Training is plain `cli.train` (in chunks with `--ckpt-every` and
`--resume` where a time limit needs them).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
import sys
import time

_ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

# in the JAX script's order: generate_dataset seeds scene k with k
SCENES = ("chess", "fire", "heads", "office", "pumpkin", "redkitchen",
          "stairs")

TRAIN_CMD = ("python -m relpose_gnn_tpu_torch.cli.train --dataset 7Scenes "
             "--experiment 0 --test-scene multi --train-data-dir {graphs} "
             "--test-data-dir {graphs} --save-dir {out} --exp-name acc_r05 "
             "--model-name R3 --batch-size 8 --seq-len 8 --max-epoch 200 "
             "--eval-after-epoch 100 --ckpt-every 10 --device-cache "
             "--resume --seed 0")
TEST_CMD = ("python -m relpose_gnn_tpu_torch.cli.test --dataset 7Scenes "
            "--test-scene multi --test-data-dir {graphs} --save-dir {out} "
            "--weights-filename {ckpt} --batch-size 8 --seq-len 8")


def prepare(root: str, frames_per_seq: int, train_seqs: int,
            test_seqs: int, height: int, width: int, seq_len: int,
            scenes=SCENES, device: str | None = None) -> None:
    """Raw scenes under <root>/raw, stats under <root>/stats, stores under
    <root>/graphs.  All seven scenes go through one `multi` build per
    split, as the JAX script does; another set one build per scene."""
    from relpose_gnn_tpu_torch.data.synthetic_scenes import generate_dataset

    raw = osp.join(root, "raw")
    stats = osp.join(root, "stats")
    graphs = osp.join(root, "graphs")
    t0 = time.time()
    generate_dataset(raw, scenes, stats, n_train_seqs=train_seqs,
                     n_test_seqs=test_seqs, frames_per_seq=frames_per_seq,
                     height=height, width=width, seed=0)
    print(f"raw scenes written ({time.time() - t0:.0f}s)", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    names = ["multi"] if tuple(scenes) == SCENES else list(scenes)
    for mode in ("train", "test"):
        for name in names:
            cmd = [sys.executable, "-m",
                   "relpose_gnn_tpu_torch.cli.build_graphs", name, mode,
                   "--data-path", raw, "--graph-data-path", graphs,
                   "--stats-path", stats, "--sampling-method", "RAND",
                   "--seq-len", str(seq_len)]
            if device is not None:
                cmd += ["--device", device]
            print(" ".join(cmd), flush=True)
            subprocess.run(cmd, check=True, env=env)
    print(f"prepare done ({time.time() - t0:.0f}s)")


def report(logdir: str, out_path: str, graphs: str, out_root: str,
           eval_dir: str | None = None, wall_s: float | None = None
           ) -> dict:
    """The campaign's document from <logdir>/metrics.jsonl; written to
    `out_path` and returned."""
    metrics = osp.join(logdir, "metrics.jsonl")
    loss_curve, eval_curves = [], {}
    with open(metrics) as f:
        for line in f:
            rec = json.loads(line)
            if "scene" in rec:
                eval_curves.setdefault(rec["scene"], []).append(
                    {"epoch": rec["epoch"],
                     "median_t": round(rec["median_t"], 4),
                     "median_q": round(rec["median_q"], 3)})
            elif "loss" in rec:
                loss_curve.append({"epoch": rec["epoch"],
                                   "loss": round(rec["loss"], 4)})
    # a resumed run can log a boundary epoch again: the last record wins
    loss_curve = list({r["epoch"]: r for r in loss_curve}.values())
    eval_curves = {s: list({r["epoch"]: r for r in c}.values())
                   for s, c in eval_curves.items()}
    best = {s: {"median_t": min(r["median_t"] for r in c),
                "median_q": min(r["median_q"] for r in c)}
            for s, c in eval_curves.items()}
    final = {s: c[-1] for s, c in eval_curves.items()}

    npz_files = []
    if eval_dir and osp.isdir(eval_dir):
        for dirpath, _, names in os.walk(eval_dir):
            npz_files += [osp.relpath(osp.join(dirpath, n), eval_dir)
                          for n in names if n.endswith(".npz")]

    doc = {
        "protocol": "full driver: synthetic scenes -> cli/build_graphs.py "
                    "-> cli/train.py (200 epochs, in-loop eval > 100, "
                    "ckpt 149/199) -> cli/test.py -> npz",
        "config": {"model": "R3 (ResNet34, 2048-dim GNN)", "dims": "256x341",
                   "graph": "fc8", "batch_size": 8, "epochs": 200,
                   "lr": 1e-4, "lr_decay_step": 50, "retrieval": "RAND",
                   "data": "data/synthetic_scenes.py (7 scenes)"},
        "reproduce": {
            "prepare": "python -m relpose_gnn_tpu_torch.benchmarks.campaign "
                       "prepare --root <R>",
            "train": TRAIN_CMD.format(graphs=graphs, out=out_root),
            "test": TEST_CMD.format(graphs=graphs, out=out_root,
                                    ckpt=osp.join(logdir, "ckpt")),
        },
        "loss_curve": loss_curve,
        "eval_curves": eval_curves,
        "best_medians": best,
        "final_medians": final,
        "npz_exports": sorted(npz_files),
    }
    if wall_s is not None:
        doc["wall_clock_s"] = round(wall_s, 1)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out_path}: final medians "
          + ", ".join(f"{s}={v['median_t']:.3f}m/{v['median_q']:.1f}deg"
                      for s, v in sorted(final.items())))
    return doc


def main(argv=None):
    p = argparse.ArgumentParser("convergence campaign")
    sub = p.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("prepare")
    pp.add_argument("--root", required=True)
    pp.add_argument("--frames-per-seq", type=int, default=32)
    pp.add_argument("--train-seqs", type=int, default=2)
    pp.add_argument("--test-seqs", type=int, default=1)
    pp.add_argument("--height", type=int, default=256)
    pp.add_argument("--width", type=int, default=341)
    pp.add_argument("--seq-len", type=int, default=8)
    pp.add_argument("--scenes", nargs="+", default=list(SCENES),
                    choices=SCENES)
    pp.add_argument("--device", default=None,
                    help="passed to cli.build_graphs; default: the CUDA "
                         "card, 'cpu' must be asked for")
    pr = sub.add_parser("report")
    pr.add_argument("--logdir", required=True,
                    help="<save-dir>/7Scenes/multi/acc_r05")
    pr.add_argument("--out", default=None,
                    help="default: <logdir>/acc_report.json")
    pr.add_argument("--graphs", default="<root>/graphs")
    pr.add_argument("--out-root", default="<root>/out")
    pr.add_argument("--eval-dir", default=None,
                    help="save-dir tree holding cli.test's npz exports")
    pr.add_argument("--wall-s", type=float, default=None)
    args = p.parse_args(argv)
    if args.cmd == "prepare":
        return prepare(args.root, args.frames_per_seq, args.train_seqs,
                       args.test_seqs, args.height, args.width,
                       args.seq_len, tuple(args.scenes), args.device)
    return report(args.logdir,
                  args.out or osp.join(args.logdir, "acc_report.json"),
                  args.graphs, args.out_root, eval_dir=args.eval_dir,
                  wall_s=args.wall_s)


if __name__ == "__main__":
    main(sys.argv[1:])
