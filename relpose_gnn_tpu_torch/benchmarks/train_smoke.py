"""The learning check: R3 at full width trained on the synthetic pose task.

    python -m relpose_gnn_tpu_torch.benchmarks.train_smoke
    python -m relpose_gnn_tpu_torch.benchmarks.train_smoke --device cpu \\
        --steps 4 --every 2 --batch 2 --eval-batch 4 --backbone resnet18 \\
        --dims 32 --seq-len 4 --height 32 --width 40 --dtype float32

Counterpart of the JAX package's `benchmarks/train_smoke_tpu.py`, with its
protocol as the defaults: preset R3 in bf16, random weights from `--seed`,
Adam at lr 3e-4 with no weight decay and no decay of the rate within the
run (`steps_per_epoch=1000`), a fresh batch of 16 eight-node 256x341
graphs of the learnable synthetic task (`data/synthetic.py`) every step,
made on the device, and a held-out batch of 32 made once.  The held-out
median translation error (`median_t`, with `median_q`) is printed before
training and every `--every` steps; the JAX script calls the run learned
when the last one is below half the first.  The error is known to rise
for the first few hundred steps before it falls, so a shortened run says
nothing.  The model learns the three translation components one at a
time, each after a plateau: the train-mode `t_loss` steps down from
2 / sqrt(pi) = 1.128 (a component of the difference of two N(0, 1)
translations: nothing learned) by about a third of that per component.

Ends with ONE JSON line: before, after, the trajectory ({step, loss,
t_loss, median_t, median_q} at step 0 and every `--every` steps; `loss`
is the last step's, `t_loss` the mean train-mode translation L1 of the
steps since the evaluation before), whether every step's loss was finite,
steps, seconds (training and the in-loop evals), steps/s, and the
attention kernel's launches (2 per train step and 2 per eval batch at
gnn_recursion 2 on the card; 0 on the CPU, where the plain version
runs).  Runs on the card unless `--device cpu` asks otherwise.
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.benchmarks import _util
from relpose_gnn_tpu_torch.benchmarks._synthetic import DTYPES
from relpose_gnn_tpu_torch.data.synthetic import make_device_batch_fn
from relpose_gnn_tpu_torch.evaluation.evaluator import compute_pose_errors
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.ops import att_core
from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                    create_train_state,
                                                    make_eval_step,
                                                    make_train_step)

# the JAX script's keys: init 0, training data and steps 1, held-out 999
_TRAIN_SEED, _TEST_SEED = 1, 999


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--every", type=int, default=100,
                    help="held-out evaluation every this many steps")
    ap.add_argument("--batch", type=int, default=16,
                    help="graphs per train step")
    ap.add_argument("--eval-batch", type=int, default=32,
                    help="graphs in the held-out batch")
    ap.add_argument("--backbone", default=None,
                    help="override R3's backbone (resnet18 / resnet34)")
    ap.add_argument("--dims", type=int, default=None,
                    help="override feat_dim, edge_dim and node_dim")
    ap.add_argument("--seq-len", type=int, default=8,
                    help="nodes per graph")
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=341)
    ap.add_argument("--dtype", default="bfloat16", choices=tuple(DTYPES))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    ap.add_argument("--json", default="",
                    help="also write the result record to this path")
    return ap.parse_args(argv)


def _train(args, state, train_step, gen_train, held_out, log):
    """The held-out error before training and every `--every` steps of
    it.  Returns (trajectory, every step's loss, the loop's start)."""
    mt, mq = held_out()
    trajectory = [{"step": 0, "loss": None, "t_loss": None, "median_t": mt,
                   "median_q": mq}]
    log(f"before: median_t={mt:.4f} median_q={mq:.3f}")
    losses, t_losses = [], []
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = gen_train(_TRAIN_SEED, i)   # new data every step
        m = train_step(state, batch, _TRAIN_SEED)
        losses.append(m["loss"])
        t_losses.append(m["t_loss"])
        if (i + 1) % args.every == 0 or i + 1 == args.steps:
            mt, mq = held_out()
            loss = float(losses[-1])
            # the train-mode (dropout on) translation L1 of the steps
            # since the last evaluation
            t_loss = float(torch.stack(t_losses).mean())
            t_losses = []
            trajectory.append({"step": i + 1, "loss": loss, "t_loss": t_loss,
                               "median_t": mt, "median_q": mq})
            log(f"step {i + 1}: loss={loss:.4f} t_loss={t_loss:.4f} "
                f"median_t={mt:.4f} median_q={mq:.3f} "
                f"({time.perf_counter() - t0:.1f} s)")
    return trajectory, losses, t0


def main(argv=None, log=print) -> dict:
    """Run the check; `log` takes each progress line (chip_smoke.py
    tags them).  Returns the record it prints last."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    kw = {"num_nodes": args.seq_len, "knn": min(4, args.seq_len - 2)}
    if args.backbone is not None:
        kw["backbone"] = args.backbone
    if args.dims is not None:
        kw.update(feat_dim=args.dims, edge_dim=args.dims, node_dim=args.dims)
    cfg = RelPoseGNNConfig.preset("R3", dtype=DTYPES[args.dtype], **kw)
    tcfg = TrainerConfig(lr=3e-4, steps_per_epoch=1000, weight_decay=0.0)
    n, h, w = args.seq_len, args.height, args.width
    gen_train = make_device_batch_fn(args.batch, n, h, w, device=device)
    test_batch = make_device_batch_fn(args.eval_batch, n, h, w,
                                      device=device)(_TEST_SEED, 0)

    with torch.device(device):
        model = RelPoseGNN(cfg)
    init_weights(model, torch.Generator(device=device).manual_seed(
        args.seed))
    state = create_train_state(model, tcfg)
    train_step = make_train_step(tcfg)
    eval_step = make_eval_step()

    def held_out() -> tuple[float, float]:
        out = eval_step(state, test_batch)
        err = compute_pose_errors(out["pred"].cpu().numpy(),
                                  out["target"].cpu().numpy())
        return err.median_t, err.median_q

    launches0 = att_core.LAUNCHES
    _util.reset_peak_memory(device)
    trajectory, losses, t0 = _train(args, state, train_step, gen_train,
                                    held_out, log)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    losses_finite = bool(torch.isfinite(torch.stack(losses)).all()) \
        if losses else True
    before, after = trajectory[0]["median_t"], trajectory[-1]["median_t"]
    learned = after < 0.5 * before
    log(f"after {args.steps} steps ({seconds:.1f} s): median_t "
        f"{before:.4f} -> {after:.4f} "
        f"({'LEARNED' if learned else 'weak'})")
    record = {
        "before": before, "after": after, "learned": learned,
        "trajectory": trajectory, "losses_finite": losses_finite,
        "steps": args.steps, "batch": args.batch, "seed": args.seed,
        "eval_batch": args.eval_batch, "eval_batches": len(trajectory),
        "seconds": seconds,
        "steps_per_s": args.steps / seconds if seconds > 0 else math.nan,
        "attention_launches": att_core.LAUNCHES - launches0,
        "peak_memory_gib": _util.peak_memory_gib(device),
        "dtype": args.dtype, "hw": [h, w], **_util.device_record(device)}
    _util.emit(record, args.json)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
