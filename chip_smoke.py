"""Smoke run of the PyTorch port (relpose_gnn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path, cached relocalization serving on preset R3,
once at full width, and checks every hand-written kernel on the way.  Each
phase prints one line; any failure raises, and the run exits non-zero
without a result line.  There is no CPU fallback: without CUDA it exits 1
at once.

  1. device  the card's name; `nvidia-smi` name and power limit; TF32 off
  2. build   the CUDA kernels, compiled from csrc/ (seconds, registers)
  3. kernel  each kernel against its plain PyTorch version on the card,
             float32 and bfloat16 inputs, rtol = atol = 1e-5
  4. slice   R3 (ResNet34, dims 2048, kNN-4 compact edges, BN folded),
             seeded random weights, bfloat16: `evaluate_scene_cached` over
             a synthetic packed store of 48 query graphs at 256x341 with 64
             database frames, batch 16; predictions finite [48, 6]; the
             attention kernel launched gnn_recursion x batches times; pose
             error medians (meaningless on random weights); then one
             float32 batch with the kernel against the same batch with the
             plain core swapped in, and against its neighbours encoded
             from the graphs' own pixels instead of the database cache
  5. time    CUDA events, median of 20 iterations after warm-up: the
             attention core (kernel vs plain) and the R3 cached eval step
             at batch 128 in bfloat16 (queries/s, peak device memory)

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from relpose_gnn_tpu.data.packed import PackedGraphDataset, PackedGraphWriter
from relpose_gnn_tpu_torch.data.pipeline import make_normalizer
from relpose_gnn_tpu_torch.evaluation import serving
from relpose_gnn_tpu_torch.evaluation.evaluator import compute_pose_errors
from relpose_gnn_tpu_torch.models.fold_bn import fold_relpose_backbone
from relpose_gnn_tpu_torch.models.posenet import (RelPoseGNN,
                                                  RelPoseGNNConfig,
                                                  init_weights)
from relpose_gnn_tpu_torch.ops import _build, att_core

SEED = 0
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# kernel vs plain core inside the whole float32 model: the core agrees to
# ~1e-6 relative, and the layers after it carry that through
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
H, W = 256, 341
N_DB, N_QUERIES, BATCH = 64, 48, 16
BENCH_BATCH, ITERS = 128, 20


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_median_ms(fn, iters: int = ITERS, warmup: int = 3) -> float:
    """Median over `iters` calls of fn's device time (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels(dev) -> float:
    """Phase 3: attention kernel vs plain; returns the largest error."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    for e, c in ((32, 128), (40, 256), (7, 4), (4096, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            args = [torch.randn(e, c, device=dev, generator=gen).to(dtype)
                    for _ in range(3)]
            got = att_core.attention_core(*args)
            want = att_core.attention_core_plain(*args)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            check(torch.allclose(got, want, **KERNEL_TOL),
                  f"attention kernel differs from plain at E={e} C={c} "
                  f"{dtype}: max abs err {err}")
            phase("kernel", f"attention_core E={e} C={c} "
                  f"{str(dtype)[6:]}: max abs err {err:.3e}")
    return worst


def write_store(root: str, rng: np.random.Generator) -> np.ndarray:
    """Synthetic packed store: N_QUERIES graphs [query | 7 database
    neighbours] at HxW; returns the uint8 database frames."""
    db = rng.integers(0, 256, size=(N_DB, H, W, 3), dtype=np.uint8)
    db_poses = rng.normal(size=(N_DB, 6)).astype(np.float32)
    writer = PackedGraphWriter(root, N_QUERIES, 8, H, W,
                               mean=[0.485, 0.456, 0.406],
                               std=[0.229, 0.224, 0.225])
    for _ in range(N_QUERIES):
        nbr = rng.choice(N_DB, 7, replace=False)
        query = rng.integers(0, 256, size=(1, H, W, 3), dtype=np.uint8)
        imgs = np.concatenate([query, db[nbr]]).astype(np.float32) / 255.0
        poses = np.concatenate([rng.normal(size=(1, 6)), db_poses[nbr]])
        writer.add(imgs, poses.astype(np.float32), ~np.eye(8, dtype=bool),
                   nbr_idx=nbr)
    writer.finalize()
    return db


def r3_model(dev) -> RelPoseGNN:
    """R3 serving form: seeded weights, random BN statistics, folded."""
    cfg = RelPoseGNNConfig.preset("R3", dtype=torch.bfloat16,
                                  compact_edges=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.device(dev):
        model = RelPoseGNN(cfg).eval()
    init_weights(model, gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.8, 1.2, generator=gen)
    _, folded = fold_relpose_backbone(model)
    return folded


def run_slice(dev, model: RelPoseGNN, tmp: str) -> int:
    """Phase 4; returns the attention-kernel launches of the main path."""
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    db = write_store(tmp, rng)
    ds = PackedGraphDataset(tmp)
    phase("slice", f"packed store: {len(ds)} graphs of 8 nodes at {H}x{W}, "
          f"{N_DB} database frames ({time.perf_counter() - t0:.1f} s)")

    n_batches = -(-N_QUERIES // BATCH)
    att_core.LAUNCHES = 0
    t0 = time.perf_counter()
    out = serving.evaluate_scene_cached(model, ds, db, batch_size=BATCH,
                                        fuse="first", device=dev)
    torch.cuda.synchronize()
    launches = att_core.LAUNCHES
    wall = time.perf_counter() - t0
    pred = out["pred"]
    check(pred.shape == (N_QUERIES, 6), f"pred shape {pred.shape}")
    check(bool(np.isfinite(pred).all()), "non-finite predictions")
    want = model.cfg.gnn_recursion * n_batches
    check(launches == want, f"attention kernel launched {launches} times "
          f"on the main path, expected {want}")
    err = compute_pose_errors(out["pred"], out["target"])
    phase("slice", f"R3 bf16 evaluate_scene_cached: {N_QUERIES} queries in "
          f"{n_batches} batches, pred {pred.shape} finite, attention "
          f"kernel launches {launches} (= {model.cfg.gnn_recursion} x "
          f"{n_batches}), {wall:.2f} s first run incl. warm-up")
    phase("slice", f"pose errors on random weights: median "
          f"{err.median_t:.4f} m, {err.median_q:.4f} deg")

    # one float32 batch: kernel vs the plain core swapped in
    cfg32 = dataclasses.replace(model.cfg, dtype=None)
    with torch.device(dev):
        model32 = RelPoseGNN(cfg32).eval()
    model32.load_state_dict(model.state_dict(), strict=True)
    normalize = make_normalizer(ds.mean, ds.std, dev)
    batch = ds.batch(np.arange(BATCH), with_nbr_idx=True)
    emb = serving.embed_database(model32,
                                 normalize(torch.from_numpy(db)), device=dev)
    args = (normalize(torch.from_numpy(batch["images"][:, 0])),
            emb[torch.from_numpy(batch["nbr_idx"].astype(np.int64)).to(dev)],
            torch.from_numpy(batch["poses"][:, 1:]).to(dev),
            torch.from_numpy(batch["adj"]).to(dev))
    step = serving.make_cached_eval_step(model32)
    got = step(*args)
    with mock.patch.object(att_core, "attention_core",
                           att_core.attention_core_plain):
        want_out = step(*args)
    check(torch.equal(got["nbr"], want_out["nbr"]),
          "anchors differ between kernel and plain core")
    diff = (got["pred"] - want_out["pred"]).abs().max().item()
    scale = want_out["pred"].abs().max().item()
    check(torch.allclose(got["pred"], want_out["pred"], **SLICE_TOL),
          f"fp32 batch: kernel vs plain pred differ by {diff}")
    phase("slice", f"fp32 batch of {BATCH}: anchors equal, pred max abs "
          f"diff {diff:.3e} (max |pred| {scale:.3e}, rtol=atol=1e-4)")

    # the same batch with its neighbours encoded from the graph's own
    # stored pixels instead of gathered from the database cache: checks
    # the cache and the nbr_idx gather (the cached path's whole premise)
    with torch.inference_mode():
        nbr_pix = model32.encode_nodes(
            normalize(torch.from_numpy(batch["images"][:, 1:])))
    full = step(args[0], nbr_pix, *args[2:])
    check(torch.equal(got["nbr"], full["nbr"]),
          "anchors differ between cached and pixel neighbour embeddings")
    diff = (got["pred"] - full["pred"]).abs().max().item()
    check(torch.allclose(got["pred"], full["pred"], **SLICE_TOL),
          f"fp32 batch: cached vs pixel-path pred differ by {diff}")
    phase("slice", f"fp32 batch of {BATCH}: cached neighbour embeddings vs "
          f"the graphs' own pixels: anchors equal, pred max abs diff "
          f"{diff:.3e} (rtol=atol=1e-4)")
    return launches


def time_all(dev, model: RelPoseGNN, card: str) -> dict:
    """Phase 5: device times.  Returns the attention core's at the main
    path's shape (E = 32 x batch 128, C = 256, bf16 inputs)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    core = {}
    for e in (4096, 16384):
        for dtype in (torch.bfloat16, torch.float32):
            args = [torch.randn(e, 256, device=dev, generator=gen).to(dtype)
                    for _ in range(3)]
            k = cuda_median_ms(lambda: att_core.attention_core(*args))
            p = cuda_median_ms(lambda: att_core.attention_core_plain(*args))
            core[(e, dtype)] = (k, p)
            phase("time", f"attention_core E={e} C=256 {str(dtype)[6:]}: "
                  f"kernel {k} ms, plain {p} ms ({card})")

    rng = np.random.default_rng(SEED + 1)
    normalize = make_normalizer([0.485, 0.456, 0.406],
                                [0.229, 0.224, 0.225], dev)
    q = normalize(torch.from_numpy(rng.integers(
        0, 256, size=(BENCH_BATCH, H, W, 3), dtype=np.uint8)))
    nbr_emb = torch.randn(BENCH_BATCH, 7, model.cfg.feat_dim, device=dev,
                          generator=gen)
    poses = torch.randn(BENCH_BATCH, 7, 6, device=dev, generator=gen)
    adj = torch.ones(BENCH_BATCH, 8, 8, dtype=torch.bool, device=dev)
    step = serving.make_cached_eval_step(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    runs = []
    for plain in (False, True, True, False):
        if plain:
            with mock.patch.object(att_core, "attention_core",
                                   att_core.attention_core_plain):
                runs.append(cuda_median_ms(lambda: step(q, nbr_emb, poses,
                                                        adj)))
        else:
            runs.append(cuda_median_ms(lambda: step(q, nbr_emb, poses, adj)))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    k_ms, p_ms = statistics.mean(runs[::3]), statistics.mean(runs[1:3])
    phase("time", f"R3 cached eval step, batch {BENCH_BATCH}, bf16, "
          f"{H}x{W}: kernel {runs[0]}/{runs[3]} ms = "
          f"{BENCH_BATCH / k_ms * 1e3} q/s; plain core "
          f"{runs[1]}/{runs[2]} ms = {BENCH_BATCH / p_ms * 1e3} q/s; "
          f"peak memory {peak} GiB ({card})")
    return {"ms": core[(4096, torch.bfloat16)][0],
            "plain_ms": core[(4096, torch.bfloat16)][1]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = nvidia_smi()
    phase("device", f"{kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; TF32 off")
    print(card, flush=True)

    t0 = time.perf_counter()
    lib = _build.build("att_core")
    with open(f"{lib}.log") as log:
        regs = [ln.strip() for ln in log if "registers" in ln]
    phase("build", f"att_core.cu -> {lib.name} in "
          f"{time.perf_counter() - t0:.2f} s; {'; '.join(regs)}")

    max_err = check_kernels(dev)

    model = r3_model(dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_slice(dev, model, tmp)

    times = time_all(dev, model, card)
    print(json.dumps({"kernels": [{
        "name": "attention_core", "route": "cuda",
        "source": "relpose_gnn_tpu_torch/csrc/att_core.cu",
        "replaces": "relpose_gnn_tpu/ops/att_pallas.py:45",
        "launches": launches, "max_abs_err": max_err, **times}]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
