#!/usr/bin/env bash
# The convergence campaign end to end, then the shared-trunk re-gate, on the
# card:
#
#   bash relpose_gnn_tpu_torch/benchmarks/run_campaign.sh ROOT [RECORDS]
#
# `campaign prepare` at its defaults (7 scenes, 3 sequences of 32 frames,
# 256x341) under ROOT; `cli.train` with the campaign's TRAIN_CMD flags (R3
# bf16, batch 8, 200 epochs, an eval of every scene after epoch 100, a
# checkpoint every 10 epochs, the device cache, --resume: where a time
# limit cuts it, the same line again carries on from the last checkpoint);
# `cli.test` on the last checkpoint; `campaign report` (with the wall-clock
# seconds of train + test); `regate_shared_trunk` on that checkpoint;
# `bench_train` at batch 8 (the train step's ms).  The records,
# metrics.jsonl and the train log are copied to RECORDS (default
# ROOT/records).  Run from the repository root.
set -euo pipefail
ROOT=$(realpath -m "$1")
RECORDS=$(realpath -m "${2:-$ROOT/records}")
mkdir -p "$ROOT" "$RECORDS"
GRAPHS=$ROOT/graphs
OUT=$ROOT/out
LOGDIR=$OUT/7Scenes/multi/acc_r05

python -m relpose_gnn_tpu_torch.benchmarks.campaign prepare --root "$ROOT"

read -r -a TRAIN <<< "$(python -c "from relpose_gnn_tpu_torch.benchmarks.campaign import TRAIN_CMD; print(TRAIN_CMD.format(graphs='$GRAPHS', out='$OUT'))")"
read -r -a TEST <<< "$(python -c "from relpose_gnn_tpu_torch.benchmarks.campaign import TEST_CMD; print(TEST_CMD.format(graphs='$GRAPHS', out='$OUT', ckpt='$LOGDIR/ckpt'))")"
t0=$(date +%s.%N)
"${TRAIN[@]}"
"${TEST[@]}"
wall=$(python -c "import time; print(time.time() - $t0)")
python -m relpose_gnn_tpu_torch.benchmarks.campaign report --logdir "$LOGDIR" \
  --graphs "$GRAPHS" --out-root "$OUT" --eval-dir "$OUT" --wall-s "$wall" \
  --out "$RECORDS/acc_report.json"
python -m relpose_gnn_tpu_torch.benchmarks.regate_shared_trunk \
  --ckpt "$LOGDIR/ckpt" --data-root "$ROOT/raw" --stats-root "$ROOT/stats" \
  --out "$RECORDS/regate.json"
python -m relpose_gnn_tpu_torch.benchmarks.bench_train --batches 8 \
  --json "$RECORDS/bench_train.json"
cp "$LOGDIR/metrics.jsonl" "$LOGDIR/logger.log" "$RECORDS/"
