"""Smoke run of the PyTorch port (relpose_gnn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main paths once at full width and checks every
hand-written kernel on the way.  Each phase prints one line per item; any
failure raises, and the run exits non-zero without a result line.  There
is no CPU fallback: without CUDA it exits 1 at once.

  device    the card's name; `nvidia-smi` name and power limit; TF32 off
  build     every CUDA kernel in csrc/, compiled side by side (seconds,
            registers, shared memory, spills); the pair MLP's library
            must hold wgmma, TMA loads and bulk reduce-adds (cuobjdump)
  kernel    each kernel against its plain PyTorch version on the card:
            attention_core at eleven shapes (C = 1, 4, 128, 130, 256,
            1000, 1024; E = 1, 7, 4096, 4097), float32 and bfloat16
            inputs, rtol = atol = 1e-5, also on inputs scaled by 3 and by
            8 (see KERNEL_TOL for what the float32 ones are held to), and
            rows of a batch of 4097 against the same rows launched alone
            and in a smaller batch, bit for bit; fused_pair_mlp at the
            four shapes of tests/test_pallas_gnn.py in float32 (rtol 1e-4,
            atol 1e-3, as the JAX tests hold the TPU kernel) and in
            bfloat16 on both bfloat16 routes ('wgmma' and 'mma_sync', the
            same inputs), at E = 1024 and E = 16384 with every width 2048,
            'edge' and 'msg', on both routes, at pair grids of 10, 16, 2
            and 1 nodes (operand tiles gathered, or copied by TMA through
            zero-stride views of the node table), at 1000 direct rows with
            H = 2056 and Dout = 1032 ('edge' and 'msg' operands, ragged
            against every tile), and at a shape whose widths are no
            multiples of 8, which must take 'mma_sync' and refuse 'wgmma'
            (bfloat16: see PAIR_BF16_TOL); launches counted per route;
            every attention-variant form (`ops/att_variants.py`: v1_exp2,
            v2_mxu, v3_exp2_mxu, base, v1, v2, exp2_core) against its own
            plain version and against the production kernel at E = 72 with
            C = 40 and 130, E = 64 and 4096 with C = 256, float32 and
            bfloat16 inputs (see VARIANT_REL_TOL), and `v1 == base` bit
            for bit
  pair_mlp  the bench entry `benchmarks/bench_pair_mlp.py::main` at
            B = 16, N = 8, dims 2048, in process; the pair-MLP kernel's
            launches counted, all of them on the 'wgmma' route
  bench     the attention bench entries through their `main`, in process,
            at the JAX benches' shapes (C = 256, float32):
            `bench_att_core` (E = 16384), `bench_att_variants`
            (E = 32768), `bench_att_variants2` (E = 16384, with its
            exactness check) and `bench_att_exp2` (E = 16384); every
            launch count set to 0 before and read after each.  Later, in
            the same phase name, `bench_service` (synthetic tables, 2048
            frames, both legs), `bench_service_bisect` and
            `bench_retrieval_stages` (batch 128, 2048 rows: every stage
            time positive, every share of the peak under 1) and
            `bench_eval`; `mfu` must read under 1.  After the train
            phase, `bench_train` at batches 8 and 16 (R3 bf16 train step:
            ms, graphs/s, mfu under 1, peak memory, 2 attention launches
            a step)
  slice     R3 (ResNet34, dims 2048, kNN-4 compact edges, BN folded),
            seeded random weights, bfloat16: `evaluate_scene_cached` over
            a synthetic packed store of 48 query graphs at 256x341 with 64
            database frames, batch 16; predictions finite [48, 6]; the
            attention kernel launched gnn_recursion x batches times; then
            one float32 batch with the kernel against the same batch with
            the plain core swapped in, and against its neighbours encoded
            from the graphs' own pixels instead of the database cache
  service   the relocalization service, R3 + NetVLADEncoder (VGG16, 64
            clusters x 512 = 32768-D, retrieval at 192x256), synthetic
            uint8 frames at 256x341, in `netvlad` and in `shared-trunk`
            mode: build 1024 frames into capacity 2048, add 256,
            invalidate 64, compact, save, load into a new service; 128
            uint8 queries, deterministic and stochastic; a stream of 4
            batches of 32.  Checks are listed at `exercise_service`.
  multiscene  one model serving three scenes with their own (mean, std):
            `MultiSceneService`, R3 + VGG16/NetVLAD at full width, 1024
            frames a scene in capacity 2048 (3 x 256 MiB of descriptor
            tables), batch 128 stochastic queries; each scene against a
            single-scene service on the same frames with `norm_ms`; add,
            invalidate, compact, save, load; a stream.  Checks are listed
            at `exercise_multiscene`.
  train     training at R3 full width (ResNet34 at 256x341, dims 2048,
            8-node graphs, dense kNN-4, two GNN passes, bf16, batch 8,
            seeded weights): synthetic 7-Scenes stores
            `chess_fc8_sp5_{train,test}` (64 / 16 graphs) written by
            `PackedGraphWriter`; the attention core's gradients at the
            training shape (E = 512, C = 256, float32 and bfloat16:
            kernel forward + eager backward against autograd through the
            plain version, see ATT_GRAD_REL_TOL); `run_training`
            (experiment 2) for 2 epochs with a checkpoint after each and
            an eval after the last: every loss finite, the attention
            kernel launched gnn_recursion x (train steps + eval batches)
            times; resume from epoch 0 under deterministic algorithms,
            equal to the uninterrupted run bit for bit (or, where an op
            without a deterministic CUDA form ran, within RESUME_TOL);
            `save_torch_checkpoint` -> `run_eval` with `load_torch_weights`
            into a fresh model: predictions equal bit for bit; one
            float32 train step at droprate 0 with the kernel and with the
            plain core swapped in (TRAIN_LOSS_RTOL, TRAIN_GRAD_REL_TOL)
  feed      graph construction and the data feed at R3's full width:
            512 database frames in 4 sequences and 128 queries at 256x341
            made in memory (the card's machine has no PIL to decode
            PNGs), poses through `process_poses`, embedded by
            `NetVLADIndex` (VGG16 + NetVLAD, 64 x 512, 192x256) on the
            card; `build_graphs` in IR mode (cross-connect over `seq_id`,
            sampling period 5) writes `chess_fc8_sp5_train` (512 graphs,
            1.07 GB uint8) and `_test` (128): counts, no neighbour in its
            query's sequence, node poses and pixels = the database's at
            `nbr_idx`; `DeviceCachedFeed` (nbytes, upload seconds, device
            memory) equal to `data_iterator` -> `device_prefetch` bit for
            bit over an epoch, its `eval_batches` over the ragged tail
            too; `graphio.cc` built with g++, `NativeConcatDataset` over
            both stores equal to `ConcatPackedDataset` grouped by store,
            `native_data_iterator` equal to `data_iterator`;
            `run_training` (experiment 2, batch 8, 1 epoch, then eval)
            with `device_cache=True` and with the host feed (which logs
            the native feed) under deterministic algorithms: losses
            finite, the two train states and eval medians equal bit for
            bit, the attention kernel launched gnn_recursion x (64 steps
            + 16 eval batches) times in each; `evaluate_dataset` over the
            test store with the trained state's eval step equal to
            run_training's eval; `bench_feed` in process (numpy, native
            at 1, 2 and 4 threads, the cached feed)
  time      CUDA events, median of 20 iterations after warm-up, the forms
            compared in turns within this one run: the attention core
            (kernel, its earlier form `restructured_core/v1`, `exp2_core`,
            plain version, and the one library call that computes it,
            `scaled_dot_product_attention` over one-wide heads), the
            kernel's time on the device alone (`torch.profiler`), the SM
            clock under load, and the R3 cached eval step at batch 128
            (kernel vs plain core);
            every attention-variant kernel at its bench entry's shape and
            inputs against its plain version (VARIANT_REL_TOL, and
            `v1 == base` bit for bit), with the plain version and the
            library call in turns (median of 5) and the bound, the
            kernel's own time being its bench entry's; the multi-scene
            query step, scenes in turns; the service's query step at
            batch 128 in both retrieval modes with its stages and a
            `torch.profiler` window (busy and idle share, kernels by
            time); the pair MLP (kernel on the 'wgmma' route, kernel on
            the 'mma_sync' route, plain, the concat and split-weight
            library forms) at E = 1024 and 16384, and the 'wgmma' kernel's
            time on the device alone; the R3 train step at batch 8 (step
            ms, graphs/s, peak memory, a profiler window) and the
            attention core's kernel forward and eager backward at its
            shape (E = 512, C = 256, bf16); the same step fed by
            `DeviceCachedFeed` and by the host feed (native graphio +
            `device_prefetch`) over the feed phase's train store, in
            turns, each with a profiler window (step ms with the batch's
            fetch, busy ms, idle share)

The timing helpers and the seeded models are the package's own
(`benchmarks/_util.py`, `benchmarks/_synthetic.py`).  The line before the
last is the kernels' JSON record: the production attention kernel, the
pair MLP and the seven attention-variant forms (then the card once more);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import os
import os.path as osp
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from relpose_gnn_tpu_torch.benchmarks import (_synthetic, _util,
                                              bench_att_core, bench_att_exp2,
                                              bench_att_variants,
                                              bench_att_variants2, bench_eval,
                                              bench_feed, bench_pair_mlp,
                                              bench_retrieval_stages,
                                              bench_service,
                                              bench_service_bisect,
                                              bench_train)
from relpose_gnn_tpu_torch.benchmarks._util import in_turns, median_ms
from relpose_gnn_tpu_torch.data import native_io
from relpose_gnn_tpu_torch.data.device_cache import DeviceCachedFeed
from relpose_gnn_tpu_torch.data.graph_builder import (GraphBuilderConfig,
                                                      build_graphs,
                                                      self_exclusion_mask)
from relpose_gnn_tpu_torch.data.packed import (ConcatPackedDataset,
                                               PackedGraphDataset,
                                               PackedGraphWriter)
from relpose_gnn_tpu_torch.data.pipeline import (data_iterator,
                                                 device_prefetch,
                                                 make_normalizer,
                                                 native_data_iterator,
                                                 to_float01)
from relpose_gnn_tpu_torch.data.seven_scenes import load_scene_stats
from relpose_gnn_tpu_torch.evaluation import serving
from relpose_gnn_tpu_torch.evaluation.evaluator import (compute_pose_errors,
                                                        evaluate_dataset)
from relpose_gnn_tpu_torch.evaluation.multiscene import MultiSceneService
from relpose_gnn_tpu_torch.evaluation.service import (RelocalizationService,
                                                      ServiceConfig,
                                                      similarities)
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN
from relpose_gnn_tpu_torch.ops import _build, att_core, att_variants, pair_mlp
from relpose_gnn_tpu_torch.ops import pose as pose_ops
from relpose_gnn_tpu_torch.retrieval.netvlad_index import (IMAGENET_MEAN,
                                                           IMAGENET_STD,
                                                           NetVLADIndex)
from relpose_gnn_tpu_torch.retrieval.subsample import fold_in
from relpose_gnn_tpu_torch.training.checkpoints import save_torch_checkpoint
from relpose_gnn_tpu_torch.training.experiment import (ExperimentConfig,
                                                       build_model,
                                                       evaluate_scene,
                                                       run_eval, run_training,
                                                       static_anchor_for)
from relpose_gnn_tpu_torch.training.trainer import (TrainerConfig,
                                                    create_train_state,
                                                    loss_fn, make_eval_step,
                                                    make_train_step)

SEED = 0
# attention kernel vs plain version.  y is a ratio of two sums of C
# positive weights 2^(f_j - m).  Kernel and plain version sum in different
# orders (about sqrt(C) * 2^-24 relative, 1e-6 at C = 256); `ex2.approx`
# is good to 2 ulp (2.4e-7 per weight); the kernel rounds phi * log2(e)
# once, which moves a weight by |f_j - m| * 2^-24 relative (1.2e-6 at a
# distance of 20 from the row max, where the weight is 2e-9 of the
# largest); its logit is one FMA, exact product included.  Together a few
# 1e-6 of |y|.  The plain version rounds the product phi * theta to
# float32 before the max is subtracted: an error of half an ulp of the
# logit, 2^-24 |f|, which at unit scale (|f| < 30) is 1.8e-6 and is
# covered, and for bfloat16 inputs is 0 (their products are exact in
# float32).  For float32 inputs scaled by 3 and 8 the logits reach +-200
# and +-1500 and that rounding alone moves the plain version by up to
# 2.4e-4 (measured, E = 4096, scale 8) off the function's value: there the
# kernel is held, at the same rtol = atol = 1e-5, to the plain version's
# formula evaluated in float64 on the same float32 inputs, and the plain
# version's own distance to it is printed beside.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-5)
# kernel vs plain core inside the whole float32 model: the core agrees to
# ~1e-6 relative, and the layers after it carry that through
SLICE_TOL = dict(rtol=1e-4, atol=1e-4)
PAIR_F32_TOL = dict(rtol=1e-4, atol=1e-3)
# bfloat16 pair MLP, max |kernel - plain| over max |out|.  Both round the
# hidden activation to bfloat16, but sum the first product in another
# order, so a hidden value within float32 rounding of a bfloat16 boundary
# rounds the other way in one of them: a flip of one bfloat16 ulp,
# 2^-8 |h|, which moves an output by 2^-8 |h| |w2|.  An output is a sum
# of H = 2048 terms h * w2, about sqrt(H) * rms(h * w2) = 45 rms; a few
# (up to ~8) flips of above-average terms (3 rms) in one row move it by
# 8 * 2^-8 * 3 rms = 0.09 rms, which is 2e-3 of 45 rms.
PAIR_BF16_TOL = 2e-3
# gradients of the attention core under autograd (AttentionCoreFunction:
# kernel forward, eager backward) against autograd through the plain
# version, max |diff| over max |plain gradient|.  Both evaluate the same
# VJP in float32 in other orders: sums of C = 256 terms, about
# sqrt(C) * 2^-24 = 1e-6 relative.  The Function's backward reads the
# kernel's y, within KERNEL_TOL (3e-6 measured) of the plain one; y enters
# through (g_j - y_i), a shift of the same size relative to the gradient's
# scale.  Together a few 1e-6 in float32: 1e-4 leaves room for
# cancellation.  bfloat16 inputs get bfloat16 gradients on both sides, and
# two float32 values within 1e-5 of each other can round to neighbouring
# bfloat16 values, one ulp = 2^-8 of the value: 2^-7 of the maximum.
ATT_GRAD_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
# one float32 train step, kernel vs plain core swapped in.  The forward
# differs by the core's 1e-6 relative; loss (a mean of 3072 absolute
# errors) to rtol 1e-5.  Gradients, each tensor's max |diff| over its max
# |gradient|: the 1e-6 carried back through the GNN and 36 BatchNorm'd
# convolutions stays near 1e-5; an L1 term whose residual is within 1e-6
# of zero flips its sign, which moves one of 3072 equal shares of the
# head's gradient (3e-4 of it): 1e-3 covers one such flip.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL_TOL = 1e-3
# resume where an op without a deterministic CUDA form ran: two runs whose
# gradients differ by rounding can move a weight whose gradient is near 0
# in opposite directions.  An Adam update moves a weight by
# lr * m_hat / (sqrt(v_hat) + eps), at most (1 - b1) / sqrt(1 - b2) = 3.16
# lr; two runs apart by twice that per update: 6.4 lr x updates.
RESUME_TOL = 6.4
# attention-variant kernels, max |kernel - plain| over max |y|, float32 and
# bfloat16 inputs (widened exactly on load).  y is a ratio of two sums of
# C positive weights.  Kernel and plain version sum in different orders:
# about sqrt(C) * 2^-24 relative, 1e-6 at C = 256.  expf and exp2f are
# good to 2 ulp, 2.4e-7.  The exp2 forms round phi * log2(e) once, which
# moves a weight by |f2| * 2^-24 relative, 2e-6 at |f| = 20.  The 3xTF32
# split (by truncation) drops w_lo * g_lo and the low parts' tails, about
# 2^-20 = 1e-6, the share from w alike in numerator and denominator.
# Together a few 1e-6.  1e-5 is the bar the JAX benches set.
VARIANT_REL_TOL = 1e-5
# the one library call that computes the attention core (`library_core`),
# max |library - plain| over max |y|.  It is only timed, and held to the
# plain version so that the time is that of the same function: float32
# inputs sum in float32 in another order (about 1e-6, as above); bfloat16
# inputs come back rounded to bfloat16, 2^-9 of |y| at most, after a
# softmax that may itself be kept in bfloat16 (2^-8 per weight).
LIBRARY_REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
H, W = 256, 341
N_DB, N_QUERIES, BATCH = 64, 48, 16
BENCH_BATCH, ITERS = 128, 20
ATT_BENCH_ITERS = 40
MEAN, STD = [0.485, 0.456, 0.406], [0.229, 0.224, 0.225]


@dataclasses.dataclass
class ServiceSizes:
    """How much of a deployment the service phase holds and asks."""
    build: int = 1024
    capacity: int = 2048
    add: int = 256
    invalidate: int = 64
    queries: int = 128
    embed_batch: int = 32
    stream_batches: int = 4
    stream_batch: int = 32
    retrieval_hw: tuple = (192, 256)


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def short_kernel_name(name: str) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "c10::"):
        name = name.replace(noise, "")
    return name[:150]


def profile_step(label: str, fn, step_ms: float, steps: int = 5) -> None:
    """`torch.profiler` over `steps` calls of fn after warm-up: the
    device's busy time (union of kernel intervals), the span from the
    first kernel's start to the last one's end, kernel launches per step
    and the kernels that take most of the time.  The profiler slows the
    host, so two idle shares are given: within the profiled span, and of
    `step_ms`, the step's device time measured without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        phase("time", f"{label}: the profiler recorded no device "
              "activity; busy and idle share not measured")
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    for start, end in spans[1:]:
        if start > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = start, end
        else:
            cur_e = max(cur_e, end)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    phase("time", f"{label}, profiled over {steps} steps: device busy "
          f"{busy / steps / 1e3} ms of a {span / steps / 1e3} ms span per "
          f"step (idle share {1 - busy / span} under the profiler); of "
          f"the unprofiled {step_ms} ms step the idle share is "
          f"{1 - busy / steps / 1e3 / step_ms}; "
          f"{len(kernels) / steps} device launches per step")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    for name, us in top:
        phase("time", f"    {us / steps / 1e3:.4f} ms/step "
              f"({us / busy:.1%} of busy)  {short_kernel_name(name)}")
    return {"busy_ms": busy / steps / 1e3,
            "idle_share": 1 - busy / steps / 1e3 / step_ms,
            "kernel_ms": {n: us / steps / 1e3 for n, us in by_name.items()}}


def device_ms(fn, kernel: str, calls: int = 10) -> float | None:
    """Mean time on the device of the kernel whose name contains `kernel`
    over `calls` calls of fn after warm-up, from `torch.profiler`'s
    device events: the launch alone, without the wrapper's host time that
    CUDA events around a single call also span.  None if the profiler
    recorded no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    return statistics.mean(spans) / 1e3 if spans else None


def sm_clock_under_load(fn, launches: int = 1500) -> str | None:
    """`nvidia-smi`'s SM clock and its maximum, read while `launches`
    calls of fn are queued on the card."""
    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    torch.cuda.synchronize()
    return out[0] if out else None


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def build_kernels() -> None:
    """Compile every csrc/*.cu, one nvcc each, all started together."""
    def one(name):
        t0 = time.perf_counter()
        lib = _build.build(name)
        return name, lib, time.perf_counter() - t0

    names = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    check(names == ["att_core", "att_variants", "pair_mlp"],
          f"kernel sources {names}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(one, names))
    for name, lib, secs in built:
        with open(f"{lib}.log") as log:
            used = [ln.split(" : ")[-1].strip() for ln in log
                    if "Used" in ln or "spill" in ln]
        phase("build", f"{name}.cu -> {lib.name} in {secs:.2f} s; "
              f"{'; '.join(used)}")
    phase("build", f"{len(names)} kernels side by side in "
          f"{time.perf_counter() - t0:.2f} s")
    # what the pair MLP's 'wgmma' route compiled to
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()),
                             "cuobjdump")
    lib = dict((name, lib) for name, lib, _ in built)["pair_mlp"]
    sass = subprocess.run([cuobjdump, "-sass", str(lib)],
                          capture_output=True, text=True).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG", "UTMAREDG",
                                            "SYNCS", "HMMA")}
    check(counts["HGMMA"] > 0 and counts["UTMALDG"] > 0
          and counts["UTMAREDG"] > 0,
          f"pair_mlp.cu compiled without wgmma, TMA loads or bulk "
          f"reduce-adds: {counts}")
    phase("build", f"pair_mlp.cu in SASS (cuobjdump): {counts['HGMMA']} "
          f"HGMMA (wgmma), {counts['UTMALDG']} UTMALDG (TMA tile loads), "
          f"{counts['UTMAREDG']} UTMAREDG (bulk reduce-adds), "
          f"{counts['SYNCS']} SYNCS (mbarrier operations), "
          f"{counts['HMMA']} HMMA (mma.sync, the 'mma_sync' route)")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def library_core(phi, theta, g):
    """The attention core as one library call, for `library_ms` only (the
    port never calls it): attention over one-wide heads,
    softmax_j(phi_i * theta_j) . g_j with q = phi[E, C, 1], k = theta,
    v = g and scale 1.  No fused backend takes a head width of 1, so the
    call materialises the [E, C, C] weights as the plain version does."""
    return F.scaled_dot_product_attention(
        phi[..., None], theta[..., None], g[..., None], scale=1.0)[..., 0]


def check_library_core(args, want: torch.Tensor, label: str) -> None:
    """The library call computes the same function as the plain version."""
    got = library_core(*args).float()
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    tol = LIBRARY_REL_TOL[args[0].dtype]
    check(err < tol * scale, f"library call at {label}: max abs err {err} "
          f"against the plain version (max |y| {scale}, tolerance {tol} "
          "relative)")


def plain_core_f64(phi, theta, g):
    """`attention_core_plain`'s formula evaluated in float64 on the same
    inputs (widened exactly): what the scaled float32 inputs are held to."""
    phi, theta, g = (a.double() for a in (phi, theta, g))
    w = torch.softmax(phi[:, :, None] * theta[:, None, :], dim=-1)
    return torch.einsum("eij,ej->ei", w, g)


def check_attention_kernel(dev) -> float:
    """attention kernel vs plain (see KERNEL_TOL), at unit scale and on
    inputs scaled by 3 and 8, and row independence; returns the largest
    error against the plain version at unit scale."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    shapes = ((32, 128), (40, 256), (7, 4), (4096, 256), (5, 1), (72, 130),
              (3, 1000), (2, 1024), (1, 256), (4097, 256), (4097, 130))
    for e, c in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            for scale in (1.0, 3.0, 8.0):
                args = [(torch.randn(e, c, device=dev, generator=gen)
                         * scale).to(dtype) for _ in range(3)]
                got = att_core.attention_core(*args)
                plain = att_core.attention_core_plain(*args)
                torch.cuda.synchronize()
                err = (got - plain).abs().max().item()
                label = (f"attention_core E={e} C={c} {str(dtype)[6:]} "
                         f"scale {scale:g}")
                check(bool(torch.isfinite(got).all()),
                      f"{label}: not finite")
                if scale == 1.0 or dtype == torch.bfloat16:
                    worst = max(worst, err) if scale == 1.0 else worst
                    check(torch.allclose(got, plain, **KERNEL_TOL),
                          f"{label}: kernel differs from plain, max abs "
                          f"err {err}")
                    phase("kernel", f"{label}: max abs err {err:.3e}")
                    continue
                want = plain_core_f64(*args)
                err64 = (got - want).abs().max().item()
                check(torch.allclose(got.double(), want, **KERNEL_TOL),
                      f"{label}: kernel differs from the float64 "
                      f"evaluation, max abs err {err64}")
                phase("kernel", f"{label}: max abs err {err64:.3e} against "
                      f"the float64 evaluation (the float32 plain version "
                      f"is {(plain - want).abs().max().item():.3e} off it, "
                      f"the kernel {err:.3e} off the plain version)")
    # a row's result depends on nothing but that row
    for dtype in (torch.float32, torch.bfloat16):
        args = [(torch.randn(4097, 256, device=dev, generator=gen) * 3
                 ).to(dtype) for _ in range(3)]
        big = att_core.attention_core(*args)
        for lo, hi in ((0, 1), (1, 2), (2047, 2048), (4096, 4097), (5, 77),
                       (1000, 1003)):
            part = att_core.attention_core(
                *[a[lo:hi].contiguous() for a in args])
            check(torch.equal(part, big[lo:hi]),
                  f"attention kernel: rows {lo}:{hi} of a batch of 4097 "
                  f"differ from the same rows launched alone ({dtype})")
        phase("kernel", f"attention_core {str(dtype)[6:]}: rows of a batch "
              "of 4097 equal the same rows launched alone (1 row at either "
              "end and inside, 3 rows, 72 rows), bit for bit")
    return worst


def pair_mlp_inputs(dev, gen, b, n, d, de, h, dout, mode, dtype):
    """x [B, N, D], e [B, N, N, De] and a concat-layout MLP2 for `mode`."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    k_in = (2 * d if mode == "edge" else d) + de
    return (r(b, n, d), r(b, n, n, de),
            r(k_in, h, scale=k_in ** -0.5).to(dtype), r(h) * 0.1,
            r(h, dout, scale=h ** -0.5).to(dtype), r(dout) * 0.1)


def pair_mlp_operands(x, e, fc1k, fc1b, fc2k, fc2b, mode, dtype):
    """The arguments `pair_mlp_apply` hands to `fused_pair_mlp`."""
    b, n, d = x.shape
    xf = x.reshape(b * n, d).to(dtype)
    edge = mode == "edge"
    return dict(xs=xf, xt=xf if edge else None,
                e=e.reshape(b * n * n, -1).to(dtype), w1a=fc1k[:d],
                w1b=fc1k[d:2 * d] if edge else None,
                w1c=fc1k[2 * d:] if edge else fc1k[d:], b1=fc1b, w2=fc2k,
                b2=fc2b, nodes=n)


def check_pair_mlp_kernel(dev) -> float:
    """fused_pair_mlp vs fused_pair_mlp_plain on every route; returns the
    largest absolute error over all shapes."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    before = dict(pair_mlp.ROUTE_LAUNCHES)
    expected = {route: 0 for route in before}

    def compare(label, ops, tol_fn, routes):
        nonlocal worst
        want = pair_mlp.fused_pair_mlp_plain(**ops)
        scale = want.abs().max().item()
        d, h = ops["w1a"].shape
        picked = pair_mlp.kernel_route(ops["w1a"].dtype, d,
                                       ops["e"].shape[1], h,
                                       ops["w2"].shape[1])
        check(picked == routes[0], f"{label}: kernel_route picks {picked}, "
              f"expected {routes[0]}")
        for route in routes:
            # the first route is the one the shape selects: ask for it by
            # shape (route=None), for the others by name
            got = pair_mlp.fused_pair_mlp(
                **ops, route=None if route == routes[0] else route)
            torch.cuda.synchronize()
            expected[route] += 1
            err = (got - want).abs().max().item()
            worst = max(worst, err)
            check(bool(torch.isfinite(got).all())
                  and tol_fn(got, want, err, scale),
                  f"pair-MLP kernel ({route}) differs from plain at "
                  f"{label}: max abs err {err} (max |out| {scale})")
            phase("kernel", f"fused_pair_mlp {label} [{route}]: max abs err "
                  f"{err:.3e} (max |out| {scale:.3e})")

    def f32_ok(got, want, err, scale):
        return torch.allclose(got, want, **PAIR_F32_TOL)

    def bf16_ok(got, want, err, scale):
        return err <= PAIR_BF16_TOL * scale

    def direct(e_rows, d, de, h, dout, dtype, xt=True, unit=False):
        """xs, xt, e [E, .] read row by row (nodes = 0); weights of
        N(0, 0.1^2), or scaled to keep the sums near 1 (`unit`)."""
        r = [torch.randn(*s, device=dev, generator=gen) for s in (
            (e_rows, d), (e_rows, d), (e_rows, de), (d, h), (d, h),
            (de, h), (h,), (h, dout), (dout,))]
        ops = dict(zip(("xs", "xt", "e", "w1a", "w1b", "w1c", "b1", "w2",
                        "b2"), r))
        for key in ("xs", "xt", "e"):
            ops[key] = ops[key].to(dtype)
        for key in ("w1a", "w1b", "w1c"):
            ops[key] = (ops[key] * ((2 * d + de) ** -0.5 if unit else 0.1)
                        ).to(dtype)
        ops["w2"] = (ops["w2"] * (h ** -0.5 if unit else 0.1)).to(dtype)
        if not xt:
            ops["xt"] = ops["w1b"] = None
        return ops

    # the four shapes of tests/test_pallas_gnn.py: two direct, two through
    # the pair grid (E = 72 with H = 40 is ragged against every tile), in
    # float32 (the FMA kernel) and in bfloat16 (widths all multiples of 8:
    # the wgmma kernel by shape, the mma.sync kernel by name)
    both = ("wgmma", "mma_sync")
    for dtype, ok, routes in ((torch.float32, f32_ok, ("fma",)),
                              (torch.bfloat16, bf16_ok, both)):
        name = str(dtype)[6:]
        for e_rows, d, de, h, dout in ((256, 32, 16, 512, 64),
                                       (128, 16, 16, 1024, 32)):
            compare(f"E={e_rows} D={d} De={de} H={h} Dout={dout} {name}",
                    direct(e_rows, d, de, h, dout, dtype), ok, routes)
        for b, n, d, de, h, dout, mode in ((2, 6, 24, 8, 40, 8, "edge"),
                                           (1, 4, 16, 16, 32, 16, "msg")):
            args = pair_mlp_inputs(dev, gen, b, n, d, de, h, dout, mode,
                                   dtype)
            compare(f"{mode} B={b} N={n} D={d} De={de} H={h} Dout={dout} "
                    f"{name}", pair_mlp_operands(*args, mode, dtype), ok,
                    routes)
    bf = torch.bfloat16
    # the bench shapes in bfloat16, both modes, both routes
    for n in (8, 32):
        for mode in ("edge", "msg"):
            args = pair_mlp_inputs(dev, gen, 16, n, 2048, 2048, 2048, 2048,
                                   mode, bf)
            compare(f"{mode} E={16 * n * n} D=De=H=Dout=2048 bfloat16 (max "
                    f"err <= {PAIR_BF16_TOL} max |out|)",
                    pair_mlp_operands(*args, mode, bf), bf16_ok, both)
    # other node counts: the operand tiles of the 'wgmma' route are boxes
    # of a zero-stride view of the node table when N is a power of two up
    # to 128 (N = 16: a block is part of one graph; N = 2 and 1: many
    # whole graphs), and are gathered by the producer's threads otherwise
    # (N = 10, E = 800: ragged against the 128-row block too)
    for b, n, d, de, h, dout, mode in (
            (8, 10, 2048, 2048, 2048, 2048, "edge"),
            (8, 10, 2048, 2048, 2048, 2048, "msg"),
            (16, 16, 512, 256, 512, 256, "edge"),
            (40, 2, 64, 32, 136, 72, "edge"),
            (130, 1, 64, 32, 136, 72, "edge")):
        args = pair_mlp_inputs(dev, gen, b, n, d, de, h, dout, mode, bf)
        compare(f"{mode} B={b} N={n} (E={b * n * n}) D={d} De={de} H={h} "
                f"Dout={dout} bfloat16", pair_mlp_operands(*args, mode, bf),
                bf16_ok, both)
    # ragged against the 128-row block, the hidden tile and the output
    # chunk, widths still multiples of 8: the tensor maps clip and fill
    for xt in (True, False):
        compare(f"{'edge' if xt else 'msg'} operands, 1000 direct rows, "
                "D=De=2048 H=2056 Dout=1032 bfloat16",
                direct(1000, 2048, 2048, 2056, 1032, bf, xt, unit=True),
                bf16_ok, both)
    # widths that are no multiples of 8: the mma.sync kernel's, by shape
    odd = direct(72, 20, 12, 36, 10, bf)
    compare("E=72 D=20 De=12 H=36 Dout=10 bfloat16", odd, bf16_ok,
            ("mma_sync",))
    try:
        pair_mlp.fused_pair_mlp(**odd, route="wgmma")
    except ValueError as exc:
        phase("kernel", f"fused_pair_mlp refuses route 'wgmma' there: {exc}")
    else:
        check(False, "route 'wgmma' was not refused at widths that are no "
              "multiples of 8")
    counted = {route: pair_mlp.ROUTE_LAUNCHES[route] - before[route]
               for route in before}
    check(counted == expected and min(expected.values()) > 0
          and sum(pair_mlp.ROUTE_LAUNCHES.values()) == pair_mlp.LAUNCHES,
          f"pair-MLP launches per route {counted}, expected {expected}")
    phase("kernel", f"fused_pair_mlp launches per route in this phase: "
          f"{counted}")
    return worst


# the attention-variant forms: key in att_variants.LAUNCHES -> (wrapper,
# kernel form code, TPU kernel body it replaces, bench entry that runs it)
VARIANT_FORMS = {
    "variant_core/v1_exp2": (
        functools.partial(att_variants.variant_core, "v1_exp2"), 3,
        "benchmarks/bench_att_variants.py:44", "bench_att_variants.main"),
    "variant_core/v2_mxu": (
        functools.partial(att_variants.variant_core, "v2_mxu"), 4,
        "benchmarks/bench_att_variants.py:56", "bench_att_variants.main"),
    "variant_core/v3_exp2_mxu": (
        functools.partial(att_variants.variant_core, "v3_exp2_mxu"), 5,
        "benchmarks/bench_att_variants.py:56", "bench_att_variants.main"),
    "restructured_core/base": (
        functools.partial(att_variants.restructured_core, "base"), 0,
        "relpose_gnn_tpu/ops/att_pallas.py:45", "bench_att_variants2.main"),
    "restructured_core/v1": (
        functools.partial(att_variants.restructured_core, "v1"), 1,
        "benchmarks/bench_att_variants2.py:50", "bench_att_variants2.main"),
    "restructured_core/v2": (
        functools.partial(att_variants.restructured_core, "v2"), 2,
        "benchmarks/bench_att_variants2.py:64", "bench_att_variants2.main"),
    "exp2_core": (att_variants.exp2_core, 3,
                  "benchmarks/bench_att_exp2.py:37", "bench_att_exp2.main"),
}
# the shape each bench entry runs its forms at (float32)
VARIANT_BENCH_E = {"bench_att_variants.main": 32768,
                   "bench_att_variants2.main": 16384,
                   "bench_att_exp2.main": 16384}


def check_variant_kernels(dev) -> dict:
    """Every attention-variant kernel against its own plain version and
    against the production kernel (VARIANT_REL_TOL: that kernel builds its
    logits with one FMA in the exp2 domain, so no form equals it bit for
    bit), float32 and bfloat16 inputs, at ragged shapes too; `v1` against
    `base` bit for bit.  Returns the largest
    absolute error of each form against its plain version.

    Tolerance VARIANT_REL_TOL, relative to max |y|: see its derivation."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    worst = {key: 0.0 for key in VARIANT_FORMS}
    for e, c in ((72, 40), (72, 130), (64, 256), (4096, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            args = [(torch.randn(e, c, device=dev, generator=gen) * 1.5
                     ).to(dtype) for _ in range(3)]
            k1 = att_core.attention_core(*args)
            outs, rels = {}, []
            for key, (fn, form, _, _) in VARIANT_FORMS.items():
                got = fn(*args)
                want = att_variants.PLAIN[form](*args)
                torch.cuda.synchronize()
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                err_k1 = (got - k1).abs().max().item()
                worst[key] = max(worst[key], err)
                check(bool(torch.isfinite(got).all())
                      and err < VARIANT_REL_TOL * scale
                      and err_k1 < VARIANT_REL_TOL * scale,
                      f"{key} at E={e} C={c} {dtype}: max abs err {err} "
                      f"against its plain version, {err_k1} against the "
                      f"production kernel (max |y| {scale})")
                outs[key] = got
                rels.append(max(err, err_k1) / scale)
            check(torch.equal(outs["restructured_core/v1"],
                              outs["restructured_core/base"]),
                  f"v1 differs from base at E={e} C={c} {dtype}: analytic "
                  "and scanned row max must agree bit for bit")
            phase("kernel", f"attention variants E={e} C={c} "
                  f"{str(dtype)[6:]}: {len(outs)} forms within "
                  f"{max(rels):.2e} of their plain versions and of the "
                  f"production kernel (relative to max |y|, tolerance "
                  f"{VARIANT_REL_TOL}); v1 == base bit for bit")
    return worst


# ---------------------------------------------------------------------------
# the pair-MLP bench entry
# ---------------------------------------------------------------------------


def run_pair_mlp_bench() -> int:
    """Drives `bench_pair_mlp.main` in process; returns the pair-MLP
    kernel's launches on that path."""
    pair_mlp.LAUNCHES = 0
    before = pair_mlp.ROUTE_LAUNCHES["wgmma"]
    out = bench_pair_mlp.main(["--batch", "16", "--nodes", "8", "--dims",
                               "2048", "--iters", str(ITERS)])
    torch.cuda.synchronize()
    launches = pair_mlp.LAUNCHES
    check(launches == out["kernel_calls"] and launches > 0
          and pair_mlp.ROUTE_LAUNCHES["wgmma"] - before == launches,
          f"pair-MLP kernel launched {launches} times by the bench entry "
          f"({pair_mlp.ROUTE_LAUNCHES['wgmma'] - before} on the 'wgmma' "
          f"route), expected {out['kernel_calls']}, all on 'wgmma'")
    # the concat form rounds its output to bfloat16: 2^-9 relative at most
    check(out["rel_max_diff"] < 2 ** -8,
          f"bench: kernel vs concat form differ by {out['rel_max_diff']}")
    phase("pair_mlp", f"bench entry B=16 N=8 dims 2048: kernel "
          f"{out['ms']['kernel']} ms, concat {out['ms']['concat']} ms, "
          f"split-weight {out['ms']['split']} ms; rel max diff vs concat "
          f"{out['rel_max_diff']:.3e}; kernel launches {launches}, all on "
          "the 'wgmma' route")
    return launches


# ---------------------------------------------------------------------------
# the attention bench entries
# ---------------------------------------------------------------------------


def run_attention_benches() -> tuple:
    """Drives `bench_att_core`, `bench_att_variants`, `bench_att_variants2`
    and `bench_att_exp2` in process through their `main`, at the shapes
    the JAX benches use, with every launch count set to 0 just before each
    and read just after.  Returns ({variant key: launches on its bench
    entry}, {bench entry: production-kernel launches}, {variant key: (its
    ms, the production kernel's ms in turns with it) at its bench entry's
    shape})."""
    per_turns = _util.turn_calls(ATT_BENCH_ITERS)
    variant_launches, core_launches, bench_ms = {}, {}, {}

    def drive(bench, argv, own_checks):
        """own_checks: launches of each of the bench's forms outside the
        timed turns."""
        name = f"{bench.__name__.rsplit('.', 1)[-1]}.main"
        att_core.LAUNCHES = 0
        att_variants.reset_launches()
        out = bench.main([*argv, "--iters", str(ATT_BENCH_ITERS)])
        torch.cuda.synchronize()
        core_launches[name] = att_core.LAUNCHES
        for key, n in att_variants.LAUNCHES.items():
            if VARIANT_FORMS[key][3] != name:
                check(n == 0, f"{name} launched {key} {n} times")
                continue
            check(n == own_checks + per_turns == out["launches"][key],
                  f"{name} launched {key} {n} times, expected "
                  f"{own_checks + per_turns} (record says "
                  f"{out['launches'][key]})")
            variant_launches[key] = n
            short = "exp2" if key == "exp2_core" else key.split("/")[1]
            bench_ms[key] = (out["ms"][short], out["ms"]["v0"])
        phase("bench", f"{name} E={out['e']} C={out['c']}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in out["ms"].items())
              + f"; launches {dict(att_variants.LAUNCHES)}, production "
              f"kernel {att_core.LAUNCHES}")
        return out

    att_core.LAUNCHES = 0
    out = bench_att_core.main(["--iters", str(ATT_BENCH_ITERS)])
    torch.cuda.synchronize()
    check(att_core.LAUNCHES == out["launches"] == 2 * (1 + per_turns),
          f"bench_att_core launched the kernel {att_core.LAUNCHES} times")
    check(all(v < VARIANT_REL_TOL for v in out["rel_max_diff"].values()),
          f"bench_att_core: kernel vs plain {out['rel_max_diff']}")
    core_launches["bench_att_core.main"] = att_core.LAUNCHES
    phase("bench", f"bench_att_core.main E={out['e']} C={out['c']}: "
          f"{out['ms']}; kernel launches {att_core.LAUNCHES}")

    drive(bench_att_variants, [], own_checks=1)
    out = drive(bench_att_variants2, [], own_checks=2)
    check(out["exact"]["v1"]["mismatched"] == 0, "v1 not bit-exact")
    phase("bench", f"bench_att_variants2 exactness on 64 rows: "
          f"{out['exact']}")
    drive(bench_att_exp2, [], own_checks=1)
    check(set(variant_launches) == set(VARIANT_FORMS),
          f"bench entries reached only {sorted(variant_launches)}")
    return variant_launches, core_launches, bench_ms


# ---------------------------------------------------------------------------
# cached evaluation of a packed store
# ---------------------------------------------------------------------------


def write_store(root: str, rng: np.random.Generator) -> np.ndarray:
    """Synthetic packed store: N_QUERIES graphs [query | 7 database
    neighbours] at HxW; returns the uint8 database frames."""
    db = rng.integers(0, 256, size=(N_DB, H, W, 3), dtype=np.uint8)
    db_poses = rng.normal(size=(N_DB, 6)).astype(np.float32)
    writer = PackedGraphWriter(root, N_QUERIES, 8, H, W, mean=MEAN, std=STD)
    for _ in range(N_QUERIES):
        nbr = rng.choice(N_DB, 7, replace=False)
        query = rng.integers(0, 256, size=(1, H, W, 3), dtype=np.uint8)
        imgs = np.concatenate([query, db[nbr]]).astype(np.float32) / 255.0
        poses = np.concatenate([rng.normal(size=(1, 6)), db_poses[nbr]])
        writer.add(imgs, poses.astype(np.float32), ~np.eye(8, dtype=bool),
                   nbr_idx=nbr)
    writer.finalize()
    return db


def run_slice(dev, model: RelPoseGNN, tmp: str) -> int:
    """Returns the attention-kernel launches of this path."""
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
                                        fuse="first")
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
    emb = serving.embed_database(model32, normalize(torch.from_numpy(db)))
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


# ---------------------------------------------------------------------------
# the relocalization service
# ---------------------------------------------------------------------------


def synthetic_frames(dev, n: int, seed: int) -> np.ndarray:
    """n uint8 frames [n, H, W, 3] on the host (made on the card)."""
    return _synthetic.synthetic_frames(dev, n, H, W, seed).numpy()


def same_result(a: dict, b: dict) -> bool:
    """Two query results, tensors on the card or numpy, bit for bit."""
    return all(torch.equal(torch.as_tensor(a[k]).cpu(),
                           torch.as_tensor(b[k]).cpu())
               for k in ("pose", "neighbors", "anchor"))


def exercise_service(dev, model: RelPoseGNN, netvlad, mode: str,
                     sizes: ServiceSizes, tmp: str) -> tuple:
    """One retrieval mode through the database life cycle and the query
    forms.  Returns (the deterministic service, its query batch, the
    attention kernel's launches on this path).  Checks:

      * tables have the deployment's shape; poses finite [B, 6];
      * neighbours are valid slots, none tombstoned, at every stage;
      * database frames sent as queries (one embed chunk of them) have
        themselves as rank-0 neighbour in deterministic mode;
      * results before and after compaction agree through old_to_new,
        poses bit for bit, deterministic and stochastic;
      * a service that loads the snapshot answers bit-identically;
      * a uint8 batch equals the same batch as quantised floats;
      * windowed selection (256 candidates) equals the full sort;
      * the stream equals its batches queried one by one;
      * a query's pose is what `make_cached_eval_step` gives on the
        neighbours the service chose;
      * the attention kernel is launched gnn_recursion times per batch."""
    n_all = sizes.build + sizes.add
    frames = synthetic_frames(dev, n_all, SEED + 10)
    queries = synthetic_frames(dev, sizes.queries, SEED + 11)
    rng = np.random.default_rng(SEED + 12)
    poses = rng.normal(size=(n_all, 6)).astype(np.float32)
    normalize = make_normalizer(MEAN, STD, dev)
    mean_t = torch.tensor(MEAN, device=dev)
    std_t = torch.tensor(STD, device=dev)

    def model_norm(x01):
        return (x01 - mean_t) / std_t

    def service(**kw):
        cfg = ServiceConfig(**{**dict(
            capacity=sizes.capacity, retrieval=mode,
            retrieval_hw=sizes.retrieval_hw, retrieval_candidates=256),
            **kw})
        return RelocalizationService(
            model, netvlad if mode == "netvlad" else None, cfg)

    rec = model.cfg.gnn_recursion
    total_launches = 0

    def ask(svc, q, seed=0):
        nonlocal total_launches
        att_core.LAUNCHES = 0
        out = svc.query(q, model_norm, seed)
        torch.cuda.synchronize()
        check(att_core.LAUNCHES == rec, f"{mode}: attention kernel "
              f"launched {att_core.LAUNCHES} times by one query batch, "
              f"expected {rec}")
        total_launches += att_core.LAUNCHES
        check(tuple(out["pose"].shape) == (len(q), 6)
              and bool(torch.isfinite(out["pose"]).all()),
              f"{mode}: poses not finite [B, 6]")
        nb = out["neighbors"]
        check(tuple(nb.shape) == (len(q), 7), f"{mode}: neighbours shape")
        check(bool(svc.db_valid[nb].all()),
              f"{mode}: a neighbour is a padded or tombstoned slot")
        return out

    # -- build, grow --------------------------------------------------
    det = service(deterministic=True)
    t0 = time.perf_counter()
    det.build(frames[:sizes.build], poses[:sizes.build], model_norm,
              batch=sizes.embed_batch)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    width = 64 * 512 if mode == "netvlad" else model.cfg.feat_dim
    check(tuple(det.db_desc.shape) == (sizes.capacity, width)
          and det.db_desc.dtype == torch.float32
          and tuple(det.db_emb.shape) == (sizes.capacity,
                                          model.cfg.feat_dim),
          f"{mode}: table shapes {tuple(det.db_desc.shape)}")
    t0 = time.perf_counter()
    det.add_frames(frames[sizes.build:], poses[sizes.build:], model_norm,
                   batch=sizes.embed_batch)
    torch.cuda.synchronize()
    t_add = time.perf_counter() - t0
    check(det.db_count == n_all and int(det.db_valid.sum()) == n_all,
          f"{mode}: count after growth {det.db_count}")
    mib = det.db_desc.numel() * det.db_desc.element_size() / 2 ** 20
    phase("service", f"{mode}: built {sizes.build} frames in {t_build:.2f} "
          f"s, added {sizes.add} in {t_add:.2f} s into capacity "
          f"{sizes.capacity}; descriptor table "
          f"{tuple(det.db_desc.shape)} float32 = {mib:.1f} MiB")

    # -- database frames as queries: rank 0 is the frame itself -------
    own = np.arange(sizes.build - sizes.embed_batch // 2,
                    sizes.build + sizes.embed_batch // 2)  # old and new
    out = ask(det, frames[own])
    check(out["neighbors"][:, 0].cpu().tolist() == own.tolist(),
          f"{mode}: a database frame is not its own rank-0 neighbour")
    desc = det.db_desc[:n_all]
    sim = desc[own] @ desc.T
    top2 = torch.topk(sim, 2, dim=1).values
    phase("service", f"{mode}: {len(own)} database frames (built and "
          f"added) each retrieve themselves at rank 0; smallest gap to "
          f"the runner-up {float((top2[:, 0] - top2[:, 1]).min()):.3e}")

    # -- tombstones, compaction ---------------------------------------
    dead = rng.choice(n_all, sizes.invalidate, replace=False)
    det.invalidate_frames(dead)
    sto = service(deterministic=False)
    pre = os.path.join(tmp, f"{mode}_pre.npz")
    det.save_database(pre)
    sto.load_database(pre)
    before_det = ask(det, queries)
    before_sto = ask(sto, queries, seed=5)
    for name, o in (("deterministic", before_det),
                    ("stochastic", before_sto)):
        check(not np.isin(o["neighbors"].cpu().numpy(), dead).any(),
              f"{mode}: {name} query returned a tombstoned frame")
    check(not torch.equal(before_sto["neighbors"],
                          ask(sto, queries, seed=6)["neighbors"]),
          f"{mode}: stochastic selection ignores its seed")
    old_to_new = det.compact_database()
    check(det.db_count == n_all - sizes.invalidate
          and bool((old_to_new[dead] == -1).all()),
          f"{mode}: count after compaction {det.db_count}")
    check(np.array_equal(old_to_new, sto.compact_database()),
          f"{mode}: two services compact the same tables differently")
    for name, svc, before, seed in (("deterministic", det, before_det, 0),
                                    ("stochastic", sto, before_sto, 5)):
        after = ask(svc, queries, seed)
        check(np.array_equal(
            old_to_new[before["neighbors"].cpu().numpy()],
            after["neighbors"].cpu().numpy()),
            f"{mode}: {name} neighbours changed under compaction")
        check(torch.equal(before["pose"], after["pose"]),
              f"{mode}: {name} poses changed under compaction")
    phase("service", f"{mode}: invalidated {sizes.invalidate}, compacted "
          f"to {det.db_count} rows; {sizes.queries} uint8 queries agree "
          "before and after through old_to_new, poses bit for bit, "
          "deterministic and stochastic")

    # -- snapshot into a new service ----------------------------------
    path = os.path.join(tmp, f"{mode}.npz")
    t0 = time.perf_counter()
    det.save_database(path)
    loaded = service(deterministic=True)
    loaded.load_database(path)
    t_snap = time.perf_counter() - t0
    check(loaded.db_count == det.db_count
          and torch.equal(loaded.db_desc, det.db_desc)
          and torch.equal(loaded.db_emb, det.db_emb),
          f"{mode}: loaded tables differ from the saved ones")
    after_det = ask(det, queries)
    check(same_result(ask(loaded, queries), after_det),
          f"{mode}: the loaded service answers differently")
    phase("service", f"{mode}: snapshot of "
          f"{os.path.getsize(path) / 2 ** 20:.0f} MiB saved and loaded "
          f"into a new service in {t_snap:.2f} s; it answers "
          "bit-identically")

    # -- input and selection identities -------------------------------
    check(same_result(ask(det, queries.astype(np.float32) / 255.0),
                      after_det),
          f"{mode}: uint8 batch differs from its quantised floats")
    full = service(deterministic=False, retrieval_candidates=None)
    full.load_database(path)
    check(same_result(ask(full, queries, 5), ask(sto, queries, 5)),
          f"{mode}: windowed selection differs from the full sort")
    batches = [queries[i * sizes.stream_batch:(i + 1) * sizes.stream_batch]
               for i in range(sizes.stream_batches)]
    one_by_one = [ask(sto, b, fold_in(7, i)) for i, b in enumerate(batches)]
    att_core.LAUNCHES = 0
    streamed = list(sto.query_stream(batches, model_norm, depth=2, rng=7))
    check(att_core.LAUNCHES == rec * len(batches),
          f"{mode}: stream launched the attention kernel "
          f"{att_core.LAUNCHES} times")
    total_launches += att_core.LAUNCHES
    check(len(streamed) == len(batches) and all(
        same_result(s, o) for s, o in zip(streamed, one_by_one)),
        f"{mode}: the stream differs from one-by-one queries")
    # the pose is the cached eval step's on the chosen neighbours
    nb = after_det["neighbors"]
    adj = torch.ones(len(queries), 8, 8, dtype=torch.bool, device=dev)
    ref = serving.make_cached_eval_step(det.model)(
        normalize(torch.from_numpy(queries)), det.db_emb[nb],
        det.db_poses[nb], adj & ~torch.eye(8, dtype=torch.bool, device=dev))
    check(torch.equal(ref["pred"], after_det["pose"])
          and torch.equal(ref["nbr"], after_det["anchor"]),
          f"{mode}: query pose differs from the cached eval step's")
    phase("service", f"{mode}: uint8 == quantised floats; windowed (256) "
          f"== full sort; stream of {len(batches)} x {sizes.stream_batch} "
          "at depth 2 == one by one; pose == cached eval step on the "
          f"chosen neighbours; attention kernel {rec} launches per batch, "
          f"{total_launches} on this path")
    return det, queries, total_launches


# ---------------------------------------------------------------------------
# multi-scene serving
# ---------------------------------------------------------------------------

# three scenes with their own pixel statistics (of the size of 7-Scenes'
# per-scene stats; none a power of two, so 1/std is inexact)
SCENES = {"chess": ([0.501, 0.442, 0.447], [0.207, 0.225, 0.218]),
          "fire": ([0.522, 0.462, 0.423], [0.226, 0.227, 0.215]),
          "office": ([0.473, 0.445, 0.430], [0.245, 0.240, 0.233])}


def exercise_multiscene(dev, model: RelPoseGNN, netvlad, sizes: ServiceSizes,
                        tmp: str) -> tuple:
    """One model serving three scenes at full width (R3 + VGG16/NetVLAD,
    each scene `sizes.build` frames in capacity `sizes.capacity`), queried
    at batch `sizes.queries`.  Returns (the service, {scene: queries}, the
    attention kernel's launches on this path).  Checks:

      * each scene's tables and answers equal, bit for bit, those of a
        single-scene `RelocalizationService` built on the same frames and
        queried with the scene's `norm_ms`;
      * the same pixels asked of two scenes are answered from each
        scene's own tables; growing, tombstoning and compacting one scene
        leaves the others' answers bit-identical;
      * per scene: add, invalidate, compact (answers agree through
        old_to_new, poses bit for bit), save, load into a new service
        (tables and answers bit-identical);
      * the stream equals its batches queried one by one;
      * the attention kernel is launched gnn_recursion times per batch."""
    cfg = ServiceConfig(capacity=sizes.capacity, retrieval="netvlad",
                        retrieval_hw=sizes.retrieval_hw,
                        retrieval_candidates=256)
    rec = model.cfg.gnn_recursion
    total_launches = 0
    ms = MultiSceneService(model, netvlad, cfg)
    rng = np.random.default_rng(SEED + 20)

    def ask(svc_query, n_rows):
        nonlocal total_launches
        att_core.LAUNCHES = 0
        out = svc_query()
        torch.cuda.synchronize()
        check(att_core.LAUNCHES == rec, "multi-scene: attention kernel "
              f"launched {att_core.LAUNCHES} times by one query batch, "
              f"expected {rec}")
        total_launches += att_core.LAUNCHES
        check(tuple(out["pose"].shape) == (n_rows, 6)
              and bool(torch.isfinite(out["pose"]).all())
              and tuple(out["neighbors"].shape) == (n_rows, 7),
              "multi-scene: poses not finite [B, 6] or neighbours not "
              "[B, 7]")
        return out

    frames, poses, queries, answers = {}, {}, {}, {}
    for i, (name, (mean, std)) in enumerate(SCENES.items()):
        n_all = sizes.build + sizes.add
        frames[name] = synthetic_frames(dev, n_all, SEED + 30 + i)
        poses[name] = rng.normal(size=(n_all, 6)).astype(np.float32)
        queries[name] = synthetic_frames(dev, sizes.queries, SEED + 40 + i)
        t0 = time.perf_counter()
        ms.add_scene(name, frames[name][:sizes.build],
                     poses[name][:sizes.build], mean, std,
                     batch=sizes.embed_batch)
        torch.cuda.synchronize()
        t_add = time.perf_counter() - t0
        db = ms._scenes[name]
        check(tuple(db.desc.shape) == (sizes.capacity, 64 * 512)
              and db.desc.dtype == torch.float32
              and ms.scene_count(name) == sizes.build,
              f"multi-scene: scene {name} tables {tuple(db.desc.shape)}")

        # the same scene in a single-scene service, norm_ms form
        mean_t = torch.tensor(mean, device=dev)
        std_t = torch.tensor(std, device=dev)

        def norm(x01, mean_t=mean_t, std_t=std_t):
            return (x01 - mean_t) * (1.0 / std_t)

        single = RelocalizationService(model, netvlad, cfg)
        single.build(frames[name][:sizes.build], poses[name][:sizes.build],
                     norm, batch=sizes.embed_batch)
        check(torch.equal(single.db_desc, db.desc)
              and torch.equal(single.db_emb, db.emb)
              and torch.equal(single.db_poses, db.poses)
              and torch.equal(single.db_valid, db.valid),
              f"multi-scene: scene {name} tables differ from the "
              "single-scene service's")
        q = queries[name]
        answers[name] = ask(lambda: ms.query(name, q, 5), len(q))
        want = ask(lambda: single.query(q, None, 5, norm_ms=(mean, std)),
                   len(q))
        check(same_result(answers[name], want),
              f"multi-scene: scene {name} answers differ from the "
              "single-scene service's")
        check(bool(db.valid[answers[name]["neighbors"]].all()),
              f"multi-scene: scene {name} returned a padded slot")
        del single
        mib = db.desc.numel() * db.desc.element_size() / 2 ** 20
        phase("multiscene", f"scene {name}: {sizes.build} frames embedded "
              f"in {t_add:.2f} s into capacity {sizes.capacity} "
              f"(descriptor table {mib:.0f} MiB); tables and "
              f"{len(q)} stochastic answers equal the single-scene "
              "service's with norm_ms, bit for bit")
    names = list(SCENES)
    check(ms.scenes() == names, f"multi-scene: scenes {ms.scenes()}")

    # -- scenes do not leak --------------------------------------------
    q = queries[names[0]]
    cross = ask(lambda: ms.query(names[1], q, 5), len(q))
    check(not torch.equal(cross["neighbors"], answers[names[0]]["neighbors"])
          and not torch.equal(cross["pose"], answers[names[0]]["pose"]),
          "multi-scene: the same pixels got the same answer from two scenes")

    # -- mutations of one scene ----------------------------------------
    first = names[0]
    ms.add_frames(first, frames[first][sizes.build:],
                  poses[first][sizes.build:], batch=sizes.embed_batch)
    dead = rng.choice(sizes.build + sizes.add, sizes.invalidate,
                      replace=False)
    ms.invalidate_frames(first, dead)
    before = ask(lambda: ms.query(first, queries[first], 5),
                 sizes.queries)
    check(not np.isin(before["neighbors"].cpu().numpy(), dead).any(),
          "multi-scene: a tombstoned frame was returned")
    old_to_new = ms.compact_scene(first)
    n_live = sizes.build + sizes.add - sizes.invalidate
    check(ms.scene_count(first) == n_live
          and bool((old_to_new[dead] == -1).all()),
          f"multi-scene: count after compaction {ms.scene_count(first)}")
    after = ask(lambda: ms.query(first, queries[first], 5), sizes.queries)
    check(np.array_equal(old_to_new[before["neighbors"].cpu().numpy()],
                         after["neighbors"].cpu().numpy())
          and torch.equal(before["pose"], after["pose"]),
          "multi-scene: answers changed under compaction")
    for name in names[1:]:
        check(ms.scene_count(name) == sizes.build and same_result(
            ask(lambda: ms.query(name, queries[name], 5), sizes.queries),
            answers[name]),
            f"multi-scene: scene {name} changed when {first} was mutated")
    phase("multiscene", f"scene {first}: added {sizes.add}, invalidated "
          f"{sizes.invalidate}, compacted to {n_live} rows; answers agree "
          "through old_to_new, poses bit for bit; the other scenes answer "
          "bit-identically; the same pixels get different answers from "
          "two scenes")

    # -- snapshot of all scenes into a new service ---------------------
    path = os.path.join(tmp, "multiscene.npz")
    t0 = time.perf_counter()
    ms.save_database(path)
    loaded = MultiSceneService(model, netvlad, cfg)
    loaded.load_database(path)
    t_snap = time.perf_counter() - t0
    for name in names:
        a, b = ms._scenes[name], loaded._scenes[name]
        check(a.count == b.count and torch.equal(a.desc, b.desc)
              and torch.equal(a.emb, b.emb)
              and torch.equal(a.poses, b.poses)
              and torch.equal(a.valid, b.valid) and a.hw == b.hw
              and torch.equal(a.norm_ms[1], b.norm_ms[1]),
              f"multi-scene: loaded scene {name} differs from the saved")
        check(same_result(
            ask(lambda: loaded.query(name, queries[name], 5), sizes.queries),
            ask(lambda: ms.query(name, queries[name], 5), sizes.queries)),
            f"multi-scene: the loaded scene {name} answers differently")
    phase("multiscene", f"snapshot of {len(names)} scenes, "
          f"{os.path.getsize(path) / 2 ** 20:.0f} MiB, saved and loaded "
          f"into a new service in {t_snap:.2f} s; it answers "
          "bit-identically")
    del loaded

    # -- stream ----------------------------------------------------------
    last = names[-1]
    batches = [queries[last][i * sizes.stream_batch:
                             (i + 1) * sizes.stream_batch]
               for i in range(sizes.stream_batches)]
    one_by_one = [ask(lambda: ms.query(last, b, fold_in(7, i)), len(b))
                  for i, b in enumerate(batches)]
    att_core.LAUNCHES = 0
    streamed = list(ms.query_stream(last, batches, depth=2, rng=7))
    check(att_core.LAUNCHES == rec * len(batches),
          f"multi-scene: stream launched the attention kernel "
          f"{att_core.LAUNCHES} times")
    total_launches += att_core.LAUNCHES
    check(len(streamed) == len(batches) and all(
        same_result(s, o) for s, o in zip(streamed, one_by_one)),
        "multi-scene: the stream differs from one-by-one queries")
    phase("multiscene", f"scene {last}: stream of {len(batches)} x "
          f"{sizes.stream_batch} at depth 2 == one by one; attention "
          f"kernel {rec} launches per batch, {total_launches} on this path")
    return ms, queries, total_launches


def run_service_benches() -> None:
    """Drives `bench_service` (synthetic tables of the deployment's size,
    both legs), `bench_service_bisect`, `bench_retrieval_stages` and
    `bench_eval` through their `main`, in process."""
    out = bench_service.main(["--synth-db", "--db", "2048", "--iters",
                              str(ITERS)])
    torch.cuda.synchronize()
    check(out["mfu"] is not None and 0.0 < out["mfu"] < 1.0,
          f"bench_service: mfu {out['mfu']}")
    check(out["qps"] > 0 and out["host_sync_qps"] > 0
          and out["host_pipelined_qps"] > 0, f"bench_service: {out}")
    phase("bench", f"bench_service.main batch {out['batch']} db "
          f"{out['db']} {out['retrieval_mode']}: {out['qps']} q/s "
          f"({out['step_ms']} ms), mfu {out['mfu']} "
          f"({out['flops_per_step'] / 1e12} TFLOP per step), peak memory "
          f"{out['peak_memory_gib']} GiB; host uint8 sync "
          f"{out['host_sync_qps']} q/s, pipelined "
          f"{out['host_pipelined_qps']} q/s")
    out = bench_service_bisect.main(["--batch", str(BENCH_BATCH), "--db",
                                     "2048", "--iters", str(ITERS)])
    torch.cuda.synchronize()
    stages = out["stage_ms"]
    check(set(stages) == set(bench_service_bisect.STAGES)
          and all(0 < ms < float("inf") for ms in stages.values())
          and stages["full"] > max(ms for k, ms in stages.items()
                                   if k != "full"),
          f"bench_service_bisect: {out}")
    phase("bench", f"bench_service_bisect.main batch {out['batch']} db "
          f"{out['db']} {out['retrieval_mode']}: "
          + ", ".join(f"{k} {ms} ms" for k, ms in stages.items()))
    out = bench_retrieval_stages.main(["--batch", str(BENCH_BATCH), "--db",
                                       "2048", "--iters", str(ITERS)])
    torch.cuda.synchronize()
    rows = out["stages"]
    check(list(rows) == list(bench_retrieval_stages.STAGES)
          and all(row["ms"] > 0 and 0.0 < row["bf16_peak_share"] < 1.0
                  for row in rows.values()),
          f"bench_retrieval_stages: {out}")
    phase("bench", f"bench_retrieval_stages.main batch {out['batch']} db "
          f"{out['db']} {out['rank_dtype']} table: "
          + ", ".join(f"{k} {row['ms']} ms ({row['gflop']} GFLOP, "
                      f"{row['bf16_peak_share']} of bf16 peak)"
                      for k, row in rows.items()))
    out = bench_eval.main(["--iters", str(ITERS)])
    torch.cuda.synchronize()
    check(out["mfu"] is not None and 0.0 < out["mfu"] < 1.0
          and out["value"] > 0, f"bench_eval: {out}")
    phase("bench", f"bench_eval.main batch {out['batch']}: {out['value']} "
          f"q/s ({out['step_ms']} ms), mfu {out['mfu']} "
          f"({out['step_gflops']} GFLOP per step), peak memory "
          f"{out['peak_memory_gib']} GiB")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_GRAPHS, TEST_GRAPHS, TRAIN_BATCH = 64, 16, 8


def write_train_stores(root: str, rng: np.random.Generator) -> None:
    """Synthetic 7-Scenes stores `chess_fc8_sp5_{train,test}` at HxW:
    graphs of 8 frames drawn from a pool of 96, fully connected, with
    poses and neighbour indices."""
    pool = rng.integers(0, 256, size=(96, H, W, 3), dtype=np.uint8)
    pool_poses = rng.normal(size=(96, 6)).astype(np.float32)
    for split, n in (("train", TRAIN_GRAPHS), ("test", TEST_GRAPHS)):
        writer = PackedGraphWriter(osp.join(root, f"chess_fc8_sp5_{split}"),
                                   n, 8, H, W, mean=MEAN, std=STD)
        for _ in range(n):
            idx = rng.choice(len(pool), 8, replace=False)
            writer.add(pool[idx].astype(np.float32) / 255.0,
                       pool_poses[idx], ~np.eye(8, dtype=bool),
                       nbr_idx=idx[1:])
        writer.finalize()


def train_config(root: str, **kw) -> ExperimentConfig:
    """Experiment 2 (one scene), R3 at full width, bf16, batch 8."""
    base = dict(dataset="7Scenes", experiment=2, train_scene="chess",
                test_scene="chess", train_data_dir=root,
                test_data_dir=root, save_dir=osp.join(root, "out"),
                exp_name="smoke", model_name="R3",
                batch_size=TRAIN_BATCH, seq_len=8, max_epoch=2,
                eval_after_epoch=0, ckpt_every=1, dtype="bfloat16",
                seed=SEED)
    base.update(kw)
    return ExperimentConfig(**base)


def check_attention_grad(dev) -> None:
    """The attention core's gradients at the training shape (E = B * N^2
    = 512, C = 256), kernel forward + eager backward against autograd
    through the plain version (ATT_GRAD_REL_TOL)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for dtype in (torch.float32, torch.bfloat16):
        args = [torch.randn(512, 256, device=dev, generator=gen).to(dtype)
                .requires_grad_() for _ in range(3)]
        ybar = torch.randn(512, 256, device=dev, generator=gen)
        before = att_core.LAUNCHES
        got = torch.autograd.grad(att_core.attention_core(*args), args, ybar)
        check(att_core.LAUNCHES == before + 1,
              "attention_core with grad did not launch the kernel")
        want = torch.autograd.grad(att_core.attention_core_plain(*args),
                                   args, ybar)
        errs = []
        for name, a, b in zip(("phi", "theta", "g"), got, want):
            check(a.dtype == dtype, f"grad of {name} is {a.dtype}")
            rel = ((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item()
            errs.append(rel)
            check(rel <= ATT_GRAD_REL_TOL[dtype],
                  f"attention grad of {name} ({dtype}): {rel} of max")
        phase("train", f"attention_core gradients E=512 C=256 "
              f"{str(dtype)[6:]}, kernel forward + eager backward vs "
              f"autograd through the plain version: max |diff| / max |grad| "
              f"phi {errs[0]:.3e}, theta {errs[1]:.3e}, g {errs[2]:.3e} "
              f"(tolerance {ATT_GRAD_REL_TOL[dtype]:.3e})")


def check_train_step_kernel_vs_plain(dev, root: str) -> None:
    """One float32 train step's loss and gradients at droprate 0, with
    the kernel and with the plain core swapped in (TRAIN_LOSS_RTOL,
    TRAIN_GRAD_REL_TOL)."""
    cfg = train_config(root, dtype="float32", droprate=0.0)
    ds = PackedGraphDataset(osp.join(root, "chess_fc8_sp5_train"))
    batch = next(device_prefetch(iter([ds.batch(np.arange(TRAIN_BATCH))]),
                                 ds.mean, ds.std, dev))
    tcfg = TrainerConfig()
    runs = []
    for plain in (False, True):
        state = create_train_state(build_model(cfg, dev), tcfg)
        ctx = (mock.patch.object(att_core, "attention_core",
                                 att_core.attention_core_plain)
               if plain else contextlib.nullcontext())
        before = att_core.LAUNCHES
        with ctx:
            total, _ = loss_fn(state, batch, None, tcfg)
            total.backward()
        check(att_core.LAUNCHES - before == (0 if plain else 2),
              f"float32 train step launched the kernel "
              f"{att_core.LAUNCHES - before} times (plain={plain})")
        # the absolute head and its criterion take no part in the loss
        runs.append((total.item(), {n: p.grad.clone() for n, p in zip(
            state.optimizer.names, state.optimizer.params)
            if p.grad is not None}))
        del state
    (loss_k, grads_k), (loss_p, grads_p) = runs
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p),
          f"float32 train step: loss {loss_k} with the kernel, {loss_p} "
          "with the plain core")
    check(set(grads_k) == set(grads_p), "kernel and plain core train "
          "different parameters")
    worst, worst_name = 0.0, None
    for name, gp in grads_p.items():
        scale = gp.abs().max().item()
        rel = ((grads_k[name] - gp).abs().max().item() / scale
               if scale else 0.0)
        if rel > worst:
            worst, worst_name = rel, name
    check(worst <= TRAIN_GRAD_REL_TOL,
          f"float32 train step: gradient {worst_name} differs by {worst} "
          "of its max between kernel and plain core")
    phase("train", f"float32 train step at droprate 0, batch {TRAIN_BATCH}: "
          f"loss {loss_k} (kernel) vs {loss_p} (plain core); over "
          f"{len(grads_p)} gradients the largest max |diff| / max |grad| "
          f"is {worst:.3e} ({worst_name}; tolerance {TRAIN_GRAD_REL_TOL})")


@contextlib.contextmanager
def deterministic_algorithms():
    """Deterministic algorithms on, cuDNN's included; yields the list of
    warnings, where an op that has no deterministic form on CUDA says so
    (CUBLAS_WORKSPACE_CONFIG is set in main, before cuBLAS starts)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False


def run_train(dev, root: str) -> int:
    """`run_training` at R3 full width for 2 epochs with a checkpoint
    after each and an eval after the last, resumed from epoch 0, and the
    reference `.pth.tar` both ways.  Returns the attention kernel's
    launches of the main run."""
    t0 = time.perf_counter()
    write_train_stores(root, np.random.default_rng(SEED + 3))
    phase("train", f"packed stores chess_fc8_sp5_train / _test: "
          f"{TRAIN_GRAPHS} / {TEST_GRAPHS} graphs of 8 frames at {H}x{W} "
          f"({time.perf_counter() - t0:.1f} s)")
    check_attention_grad(dev)
    # bit-for-bit resume on the card: deterministic algorithms for the
    # training runs (see `deterministic_algorithms`)
    with deterministic_algorithms() as caught:
        cfg = train_config(root)
        att_core.LAUNCHES = 0
        t0 = time.perf_counter()
        out = run_training(cfg, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = att_core.LAUNCHES
        state = out["state"]
        steps = cfg.max_epoch * (TRAIN_GRAPHS // TRAIN_BATCH)
        eval_batches = -(-TEST_GRAPHS // TRAIN_BATCH)
        want = cfg.gnn_recursion * (steps + eval_batches)
        check(state.step == steps, f"{state.step} train steps, want {steps}")
        check(launches == want, f"attention kernel launched {launches} "
              f"times in run_training, expected {want} = "
              f"{cfg.gnn_recursion} x ({steps} steps + {eval_batches} eval "
              "batches)")
        logdir = osp.join(cfg.save_dir, "7Scenes", "chess", "smoke")
        with open(osp.join(logdir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        evals = [r for r in recs if "median_t" in r]
        check(len(losses) == cfg.max_epoch and all(
            np.isfinite(x) for x in losses),
            f"epoch losses {losses} (an epoch with a non-finite loss is "
            "rolled back and writes none)")
        check(len(evals) == 1 and np.isfinite(evals[0]["median_t"]),
              f"eval records {evals}")
        phase("train", f"run_training R3 bf16 batch {TRAIN_BATCH}, "
              f"{cfg.max_epoch} epochs = {steps} steps, checkpoint after "
              f"each epoch, eval after the last: {wall:.1f} s; epoch losses "
              f"{losses} (every step finite); eval median "
              f"{evals[0]['median_t']:.4f} m, {evals[0]['median_q']:.4f} "
              f"deg; attention kernel launches {launches} (= "
              f"{cfg.gnn_recursion} x ({steps} + {eval_batches}))")

        # resume: restore epoch 0 and run epoch 1 again
        ckdir = osp.join(logdir, "ckpt")
        final = {k: v.clone() for k, v in _flat_state(state).items()}
        shutil.rmtree(osp.join(ckdir, "1"))
        before = att_core.LAUNCHES
        resumed = run_training(dataclasses.replace(cfg, resume=True),
                               device=dev)["state"]
        again = _flat_state(resumed)
        diffs = {k: (again[k].float() - v.float()).abs().max().item()
                 for k, v in final.items()}
        ops = sorted({str(w.message).split(" does not have")[0]
                      for w in caught if "deterministic" in str(w.message)})
        check(resumed.step == steps, f"resumed run: {resumed.step} steps")
        differ = {k: d for k, d in diffs.items() if d}
        if not ops:
            check(not differ, f"resumed run differs from the uninterrupted "
                  f"one: {differ}")
            held = "equal the uninterrupted run's, bit for bit"
        else:
            tol = RESUME_TOL * cfg.lr * (TRAIN_GRAPHS // TRAIN_BATCH)
            weights = {k: d for k, d in differ.items()
                       if not k.startswith("adam.")
                       and not k.endswith(("running_mean", "running_var"))}
            check(all(d <= tol for d in weights.values()),
                  f"resumed run's weights differ by more than {tol}: "
                  f"{weights}")
            held = (f"the weights and criterion within {tol} of the "
                    f"uninterrupted run's (ops without a deterministic form "
                    f"on CUDA: {ops}); {len(differ)} of them differ at all, "
                    f"largest {max(differ.values(), default=0.0)}")
        phase("train", f"resume from epoch 0 (deterministic algorithms on, "
              f"CUBLAS_WORKSPACE_CONFIG={os.environ['CUBLAS_WORKSPACE_CONFIG']}"
              f"): epoch 1 again ({att_core.LAUNCHES - before} launches); "
              f"the {len(final)} tensors of the train state (weights, BN "
              f"statistics, criterion, Adam moments and steps) {held}")

        # the reference .pth.tar out and back in: same predictions
        ds = PackedGraphDataset(osp.join(root, "chess_fc8_sp5_test"))
        trained = evaluate_scene(make_eval_step(), state, ds, TRAIN_BATCH,
                                 np.zeros(3), np.ones(3), dev)
        pth = save_torch_checkpoint(state, osp.join(root, "smoke.pth.tar"),
                                    cfg.max_epoch - 1)
        loaded = run_eval(cfg, weights=pth, save_predictions=False,
                          device=dev)["chess"]
        check(np.array_equal(loaded.pred_poses, trained.pred_poses),
              "run_eval of the exported .pth.tar differs from the trained "
              "model's predictions")
        phase("train", f"save_torch_checkpoint -> run_eval (fresh model, "
              f"load_torch_weights strict): {len(ds)} predictions equal the "
              "trained model's, bit for bit")
    check_train_step_kernel_vs_plain(dev, root)
    return launches


def _flat_state(state) -> dict:
    """Every tensor of a TrainState, by name (Adam's as name/key)."""
    sd = state.state_dict()
    flat = {f"model.{k}": v for k, v in sd["model"].items()}
    flat.update({f"{g}.{k}": v for g in ("criterion", "criterion_R")
                 for k, v in sd[g].items()})
    for name, st in sd["optimizer"]["adam"].items():
        flat.update({f"adam.{name}.{k}": torch.as_tensor(v)
                     for k, v in st.items()})
    return flat


def run_bench_train() -> int:
    """`bench_train.main` at batches 8 and 16, in process; returns the
    attention kernel's launches."""
    att_core.LAUNCHES = 0
    out = bench_train.main(["--batches", "8,16", "--iters", str(ITERS)])
    torch.cuda.synchronize()
    launches = att_core.LAUNCHES
    rows = out["train"]
    check([r["batch"] for r in rows] == [8, 16] and all(
        r["loss_finite"] and r["ms_per_step"] > 0
        and 0.0 < r["mfu"] < 1.0
        and r["attention_launches_per_step"] == 2 for r in rows),
        f"bench_train: {out}")
    check(launches > 0, "bench_train launched no attention kernel")
    for r in rows:
        phase("bench", f"bench_train.main batch {r['batch']}: "
              f"{r['ms_per_step']} ms/step = {r['graphs_per_s']} graphs/s, "
              f"mfu {r['mfu']} ({r['flops_per_step'] / 1e12} TFLOP per "
              f"step), peak memory {r['peak_memory_gib']} GiB, attention "
              f"launches per step {r['attention_launches_per_step']}")
    phase("bench", f"bench_train attention kernel launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# the data feed: stores built on the card, the cached and native feeds
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FeedSizes:
    """What the feed phase builds and trains on.  A real 7-Scenes chess
    training split has 4000 frames; 512 keep the phase inside the run's
    time limit (`reduced`)."""
    train: int = 512
    test: int = 128
    seqs: int = 4
    batch: int = TRAIN_BATCH
    eval_batch: int = 12           # 128 = 10 x 12 + 8: a ragged tail
    height: int = H
    width: int = W
    clusters: int = 64
    retrieval_hw: tuple = (192, 256)
    bench_args: tuple = ()


class FrameSet:
    """Frames made in memory behind the loaders' interface (`poses`,
    `seq_id`, `load_image`, `rel_path`): the card's machine has no PIL to
    decode the PNGs of a real split."""

    def __init__(self, frames: np.ndarray, poses: np.ndarray,
                 seq_id: np.ndarray):
        self.frames, self.poses, self.seq_id = frames, poses, seq_id

    def __len__(self) -> int:
        return len(self.frames)

    def load_image(self, i: int) -> np.ndarray:
        return self.frames[i].astype(np.float32) / 255.0

    def rel_path(self, i: int) -> str:
        return f"chess/seq-{self.seq_id[i]:02d}/frame-{i:06d}.color.png"


def seeded_poses(rng: np.random.Generator, n: int) -> np.ndarray:
    """n pose6 rows from seeded rotations and translations, through the
    port's `process_poses` (as a 7-Scenes loader makes them)."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    R = pose_ops.quat2mat(torch.from_numpy(q.astype(np.float32))).double()
    raw = np.concatenate([R.numpy(), rng.normal(size=(n, 3, 1))], axis=2)
    return pose_ops.process_poses(raw.reshape(n, 12), np.zeros(3),
                                  np.ones(3), np.eye(3), np.zeros(3),
                                  1.0).astype(np.float32)


def netvlad_inputs(dev, frames: np.ndarray, hw: tuple) -> np.ndarray:
    """uint8 frames -> NetVLAD input at `hw`, ImageNet-normalised: the
    antialiased bilinear resize the service runs on the card (the host
    path, `netvlad_preprocess_7scenes`, resizes with PIL)."""
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    out = []
    for i in range(0, len(frames), 64):
        x = to_float01(torch.from_numpy(frames[i:i + 64]).to(dev))
        x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                          mode="bilinear", antialias=True,
                          align_corners=False)
        out.append(((x.permute(0, 2, 3, 1) - mean) / std).cpu().numpy())
    return np.concatenate(out)


def build_feed_stores(dev, root: str, sizes: FeedSizes) -> FrameSet:
    """`chess_fc8_sp5_train` (IR over NetVLAD descriptors embedded on the
    card, cross-connect over `seq_id`, sampling period 5) and
    `chess_fc8_sp5_test` (queries of a fifth sequence against the same
    database) through `build_graphs`; the stores' checks.  Returns the
    database."""
    rng = np.random.default_rng(SEED + 11)
    n_all = sizes.train + sizes.test
    t0 = time.perf_counter()
    frames = _synthetic.synthetic_frames(dev, n_all, sizes.height,
                                         sizes.width, SEED + 12).numpy()
    poses = seeded_poses(rng, n_all)
    seq_id = np.concatenate([
        np.repeat(np.arange(1, sizes.seqs + 1), sizes.train // sizes.seqs),
        np.full(sizes.test, sizes.seqs + 1)]).astype(np.int32)
    db = FrameSet(frames[:sizes.train], poses[:sizes.train],
                  seq_id[:sizes.train])
    queries = FrameSet(frames[sizes.train:], poses[sizes.train:],
                       seq_id[sizes.train:])
    encoder = _synthetic.netvlad_encoder(dev, sizes.clusters,
                                         torch.bfloat16, SEED + 13)
    index = NetVLADIndex(encoder, batch_size=64, device=dev)
    index.build(netvlad_inputs(dev, db.frames, sizes.retrieval_hw))
    q_desc = index.embed(netvlad_inputs(dev, queries.frames,
                                        sizes.retrieval_hw))
    sim_db = index.similarities(index.descriptors.cpu().numpy())
    sim_q = index.similarities(q_desc)
    t_embed = time.perf_counter() - t0
    check(sim_db.shape == (sizes.train, sizes.train)
          and bool(np.isfinite(sim_db).all()) and bool(
              np.isfinite(sim_q).all()), "NetVLAD similarities")
    mean, std = load_scene_stats(None, "chess")
    cfg = GraphBuilderConfig(seq_len=8, sampling_period=5,
                             retrieval_mode="IR", cross_connect=True,
                             seed=SEED)
    t0 = time.perf_counter()
    n_train = build_graphs(
        db, db, osp.join(root, "chess_fc8_sp5_train"), cfg,
        similarity_fn=lambda qi: sim_db[qi],
        invalid_fn=lambda qi: self_exclusion_mask(
            len(db), qi, True, True, seq_ids=db.seq_id,
            query_seq=db.seq_id[qi]),
        mean=mean, std=std, height=sizes.height, width=sizes.width)
    n_test = build_graphs(
        queries, db, osp.join(root, "chess_fc8_sp5_test"),
        dataclasses.replace(cfg, cross_connect=False,
                            database_is_query_set=False),
        similarity_fn=lambda qi: sim_q[qi], mean=mean, std=std,
        height=sizes.height, width=sizes.width)
    t_build = time.perf_counter() - t0
    check((n_train, n_test) == (sizes.train, sizes.test),
          f"build_graphs wrote {n_train} / {n_test} graphs, want "
          f"{sizes.train} / {sizes.test}")
    for split, qset in (("train", db), ("test", queries)):
        ds = PackedGraphDataset(osp.join(root, f"chess_fc8_sp5_{split}"))
        nbr = np.asarray(ds.nbr_idx)
        check(len(ds) == len(qset) and nbr.shape == (len(qset), 7)
              and bool((nbr >= 0).all() and (nbr < len(db)).all()),
              f"{split} store: {len(ds)} graphs, nbr_idx {nbr.shape}")
        if split == "train":
            own = db.seq_id[nbr] == db.seq_id[:, None]
            check(not own.any(), f"{int(own.sum())} neighbours of the "
                  "train store in their query's own sequence")
        check(np.array_equal(ds.poses[:, 1:], db.poses[nbr])
              and np.array_equal(ds.poses[:, 0], qset.poses),
              f"{split} store: node poses differ from the database poses "
              "at nbr_idx")
        check(np.array_equal(ds.images[:4, 0], qset.frames[:4])
              and np.array_equal(ds.images[:4, 1:], db.frames[nbr[:4]]),
              f"{split} store: node pixels differ from the frames")
        check(ds.rel_paths == [qset.rel_path(i) for i in range(len(qset))],
              f"{split} store: rel_paths")
    nbytes = sum(osp.getsize(osp.join(root, "chess_fc8_sp5_train", f))
                 for f in ("images.npy", "poses.npy", "adj.npy"))
    phase("feed", f"stores: {sizes.train} database frames in "
          f"{sizes.seqs} sequences + {sizes.test} queries at "
          f"{sizes.height}x{sizes.width} made in memory, poses through "
          f"process_poses; NetVLADIndex ({sizes.clusters} x 512-D, "
          f"{sizes.retrieval_hw[0]}x{sizes.retrieval_hw[1]}) embedded them "
          f"on the card in {t_embed:.2f} s; build_graphs IR, cross-connect "
          f"over seq_id, sampling period 5 wrote chess_fc8_sp5_train "
          f"({n_train} graphs, {nbytes / 1e9:.3f} GB) and _test ({n_test}) "
          f"in {t_build:.1f} s; no neighbour in its query's sequence, every "
          f"node's pose = the database pose at nbr_idx, pixels = the frames")
    phase("feed", f"reduced: the chess training split (4000 frames) cut "
          f"to {sizes.train} database frames and {sizes.test} queries for "
          "the run's time limit")
    return db


def _same_batches(got, want, what: str) -> int:
    """Every batch of two iterators equal, key for key, bit for bit (on
    the device where the batches are); returns how many."""
    n = 0
    for a, b in itertools.zip_longest(got, want):
        check(a is not None and b is not None, f"{what}: batch counts "
              "differ")
        check(set(a) == set(b), f"{what}: keys {set(a)} vs {set(b)}")
        for k in a:
            x = a[k] if torch.is_tensor(a[k]) else torch.from_numpy(a[k])
            y = b[k] if torch.is_tensor(b[k]) else torch.from_numpy(b[k])
            check(x.dtype == y.dtype and torch.equal(x, y.to(x.device)),
                  f"{what}: batch {n} '{k}' differs")
        n += 1
    return n


def check_feeds(dev, root: str, sizes: FeedSizes) -> None:
    """DeviceCachedFeed against the host feed, the native feed against
    the numpy one, bit for bit."""
    train_root = osp.join(root, "chess_fc8_sp5_train")
    test_root = osp.join(root, "chess_fc8_sp5_test")
    train_ds, test_ds = (PackedGraphDataset(r)
                         for r in (train_root, test_root))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    feed = DeviceCachedFeed(train_ds, dev)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    held = torch.cuda.memory_allocated(dev) - mem0
    nbytes = feed.nbytes
    n = _same_batches(feed.epoch(seed=SEED, batch_size=sizes.batch),
                      device_prefetch(data_iterator(
                          train_ds, sizes.batch, seed=SEED, epochs=1),
                          train_ds.mean, train_ds.std, dev),
                      "DeviceCachedFeed epoch vs host feed")
    check(n == sizes.train // sizes.batch, f"{n} cached batches")
    del feed
    test_feed = DeviceCachedFeed(test_ds, dev)
    rows = [k for _, k in test_feed.eval_batches(sizes.eval_batch)]
    check(sum(rows) == sizes.test and rows[-1] == (
        sizes.test % sizes.eval_batch or sizes.eval_batch),
        f"eval_batches rows {rows}")
    _same_batches((b for b, _ in test_feed.eval_batches(sizes.eval_batch)),
                  device_prefetch(data_iterator(
                      test_ds, sizes.eval_batch, shuffle=False, epochs=1,
                      drop_remainder=False), test_ds.mean, test_ds.std,
                      dev), "DeviceCachedFeed eval_batches vs host feed")
    del test_feed
    phase("feed", f"DeviceCachedFeed(chess_fc8_sp5_train): nbytes "
          f"{nbytes}, uploaded in {upload:.3f} s, {held / 2**30:.3f} GiB of "
          f"device "
          f"memory; epoch 0 ({n} batches of {sizes.batch}) equal to "
          f"data_iterator -> device_prefetch bit for bit; eval_batches of "
          f"the test store cover {sizes.test} rows as {rows[:2]} ... "
          f"{rows[-1]}, equal to the host feed")

    t0 = time.perf_counter()
    native_io.build()
    check(native_io.available(), "native graphio did not load")
    t_build = time.perf_counter() - t0
    native = native_io.NativeConcatDataset([train_root, test_root],
                                           threads=4)
    concat = ConcatPackedDataset([train_ds, test_ds])
    rng = np.random.default_rng(SEED + 14)
    for _ in range(4):
        idx = rng.choice(len(concat), sizes.batch * 2, replace=False)
        order = np.argsort(idx >= len(train_ds), kind="stable")
        want = {k: v[order] for k, v in concat.batch(idx).items()}
        _same_batches([native.batch(idx)], [want],
                      "NativeConcatDataset vs the grouped concat feed")
    native.close()
    n = _same_batches(
        native_data_iterator(test_root, sizes.batch, seed=SEED),
        data_iterator(test_ds, sizes.batch, seed=SEED),
        "native_data_iterator vs data_iterator")
    phase("feed", f"native graphio built with g++ in {t_build:.2f} s "
          f"({native_io.library_path().name}); NativeConcatDataset over "
          f"train + test equal to ConcatPackedDataset grouped by store on 4 "
          f"batches of {sizes.batch * 2}; native_data_iterator equal to "
          f"data_iterator on the test store ({n} batches)")


def run_feed(dev, root: str, sizes: FeedSizes, model_kw: dict) -> dict:
    """The feed phase: stores, feeds, two `run_training` runs (cached and
    host feed) bit for bit, `evaluate_dataset` against run_training's
    eval, `bench_feed`.  Returns the attention kernel's launches by
    path."""
    build_feed_stores(dev, root, sizes)
    check_feeds(dev, root, sizes)
    launches, runs = {}, {}
    steps = sizes.train // sizes.batch
    eval_batches = -(-sizes.test // sizes.batch)
    with deterministic_algorithms():
        for cache in (True, False):
            name = "cached" if cache else "host"
            cfg = train_config(root, max_epoch=1, eval_after_epoch=-1,
                               ckpt_every=0, batch_size=sizes.batch,
                               device_cache=cache,
                               save_dir=osp.join(root, f"out-{name}"),
                               **model_kw)
            att_core.LAUNCHES = 0
            t0 = time.perf_counter()
            out = run_training(cfg, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[f"feed run_training {name}"] = att_core.LAUNCHES
            want = cfg.gnn_recursion * (steps + eval_batches)
            check(att_core.LAUNCHES == want, f"run_training ({name} feed) "
                  f"launched the attention kernel {att_core.LAUNCHES} "
                  f"times, want {want}")
            logdir = osp.join(cfg.save_dir, "7Scenes", "chess", "smoke")
            with open(osp.join(logdir, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            losses = [r["loss"] for r in recs if "loss" in r]
            check(len(losses) == 1 and np.isfinite(losses[0]),
                  f"{name} feed: epoch losses {losses}")
            with open(osp.join(logdir, "logger.log")) as f:
                log = f.read()
            took = ("training feed: device cache" if cache
                    else "training feed: native C++ graphio")
            check(took in log, f"run_training did not log '{took}'")
            runs[name] = out
            phase("feed", f"run_training R3 {cfg.dtype} batch "
                  f"{sizes.batch}, 1 epoch = {steps} steps + eval, {name} "
                  f"feed ('{took}'): {wall:.1f} s; loss {losses[0]}; eval "
                  f"median {out['best']['chess']['median_t']:.4f} m, "
                  f"{out['best']['chess']['median_q']:.4f} deg; attention "
                  f"kernel launches {att_core.LAUNCHES} (= "
                  f"{cfg.gnn_recursion} x ({steps} + {eval_batches}))")
        a = _flat_state(runs["cached"]["state"])
        b = _flat_state(runs["host"]["state"])
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        check(a.keys() == b.keys() and not differ,
              f"cached and host-feed runs differ in {differ[:5]}")
        check(runs["cached"]["best"] == runs["host"]["best"],
              f"eval medians {runs['cached']['best']} vs "
              f"{runs['host']['best']}")
        phase("feed", f"the cached and host-feed runs' {len(a)} train-state "
              "tensors and eval medians equal bit for bit (deterministic "
              "algorithms on)")

        state = runs["cached"]["state"]
        test_ds = PackedGraphDataset(osp.join(root, "chess_fc8_sp5_test"))
        att_core.LAUNCHES = 0
        errs = evaluate_dataset(
            make_eval_step(ref_node=0, static_anchor=static_anchor_for(cfg)),
            state, device_prefetch(data_iterator(
                test_ds, sizes.batch, shuffle=False, epochs=1,
                drop_remainder=False), test_ds.mean, test_ds.std, dev),
            np.zeros(3), np.ones(3))
        torch.cuda.synchronize()
        launches["evaluate_dataset"] = att_core.LAUNCHES
        best = runs["cached"]["best"]["chess"]
        check(errs.pred_poses.shape == (sizes.test, 7)
              and bool(np.isfinite(errs.pred_poses).all()),
              f"evaluate_dataset predictions {errs.pred_poses.shape}")
        check((errs.median_t, errs.median_q) == (best["median_t"],
                                                 best["median_q"]),
              f"evaluate_dataset medians {errs.median_t}, {errs.median_q} "
              f"vs run_training's eval {best}")
        check(att_core.LAUNCHES == 2 * eval_batches,
              f"evaluate_dataset launched {att_core.LAUNCHES} kernels")
    phase("feed", f"evaluate_dataset over chess_fc8_sp5_test ({sizes.test} "
          f"queries, the trained state's eval step): median "
          f"{errs.median_t} m, {errs.median_q} deg, equal to run_training's "
          f"eval; attention kernel launches {att_core.LAUNCHES}")

    out = bench_feed.main(list(sizes.bench_args))
    legs = out["feed"]
    check(legs["numpy"]["batches_per_s"] > 0 and legs["cached"][
        "ms_per_batch"] > 0 and [r["threads"] for r in legs["native"]] == [
        1, 2, 4], f"bench_feed: {out}")
    rows = ", ".join(f"native t={r['threads']} {r['batches_per_s']} "
                     f"batches/s = {r['gb_per_s']} GB/s"
                     for r in legs["native"])
    phase("feed", f"bench_feed.main, batches of {out['batch']} x "
          f"{out['graph_shape']} uint8 from {out['stores']} stores: numpy "
          f"{legs['numpy']['batches_per_s']} batches/s = "
          f"{legs['numpy']['gb_per_s']} GB/s; {rows}; device cache "
          f"{legs['cached']['ms_per_batch']} ms/batch = "
          f"{legs['cached']['gb_per_s']} GB/s ({out['card']})")
    return launches


def time_feed(dev, card: str, root: str, sizes: FeedSizes,
              model_kw: dict) -> dict:
    """The R3 train step at batch 8 fed by DeviceCachedFeed and by the
    host feed (the native runtime + device_prefetch), in turns: step ms
    (CUDA events around a step, the batch's fetch included), busy ms and
    the idle share of the unprofiled step."""
    cfg = train_config(root, batch_size=sizes.batch, **model_kw)
    tcfg = TrainerConfig()
    state = create_train_state(build_model(cfg, dev), tcfg)
    train_step = make_train_step(tcfg)
    train_root = osp.join(root, "chess_fc8_sp5_train")
    cached = DeviceCachedFeed(PackedGraphDataset(train_root), dev)

    def cycle():
        epoch = 0
        while True:
            yield from cached.epoch(seed=SEED + epoch,
                                    batch_size=sizes.batch)
            epoch += 1

    native = native_io.NativeConcatDataset([train_root], threads=4)
    cached_batches = cycle()
    # one epoch covers the calls below: 2 x (ITERS + 3) timed, 8 profiled
    host_batches = device_prefetch(data_iterator(
        native, sizes.batch, seed=SEED, epochs=1), native.mean, native.std,
        dev)
    forms = {"cached": lambda: train_step(state, next(cached_batches), SEED),
             "host": lambda: train_step(state, next(host_batches), SEED)}
    ms = in_turns(forms, iters=ITERS, device=dev)
    prof = {k: profile_step(f"R3 train step fed by the {k} feed", fn,
                            ms[k]) for k, fn in forms.items()}
    for _ in host_batches:  # let the host feed's thread finish its epoch
        pass
    native.close()
    phase("time", f"R3 train step, batch {sizes.batch}, in turns by feed: "
          f"DeviceCachedFeed {ms['cached']} ms, host feed (native graphio "
          f"+ device_prefetch) {ms['host']} ms; busy "
          f"{[None if p is None else p['busy_ms'] for p in prof.values()]}"
          f" ms, idle share "
          f"{[None if p is None else p['idle_share'] for p in prof.values()]}"
          f" (cached, host; {card})")
    rec = {}
    for k in forms:
        rec[f"feed_{k}_step_ms"] = ms[k]
        rec[f"feed_{k}_busy_ms"] = None if prof[k] is None else prof[k][
            "busy_ms"]
        rec[f"feed_{k}_idle_share"] = None if prof[k] is None else prof[k][
            "idle_share"]
    return rec


def time_train(dev, card: str) -> dict:
    """The R3 train step at batch 8 (bf16): step ms, graphs/s, peak
    memory, a profiler window; the attention core's kernel forward and
    eager backward at the step's shape (E = 512, C = 256, bf16)."""
    cfg = train_config("")
    tcfg = TrainerConfig()
    state = create_train_state(build_model(cfg, dev), tcfg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    n = cfg.seq_len
    batch = {"images": torch.randn(TRAIN_BATCH, n, H, W, 3, device=dev,
                                   generator=gen),
             "poses": torch.randn(TRAIN_BATCH, n, 6, device=dev,
                                  generator=gen),
             "adj": (~torch.eye(n, dtype=torch.bool, device=dev)
                     ).expand(TRAIN_BATCH, n, n).contiguous()}
    train_step = make_train_step(tcfg)

    def step():
        return train_step(state, batch, SEED)

    _util.reset_peak_memory(dev)
    step_ms = median_ms(step)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    phase("time", f"R3 train step, batch {TRAIN_BATCH}, bf16, {H}x{W}, "
          f"dense kNN-4 graph: {step_ms} ms = "
          f"{TRAIN_BATCH / step_ms * 1e3} graphs/s; peak memory {peak} GiB "
          f"({card})")
    prof = profile_step("R3 train step", step, step_ms)
    args = [torch.randn(512, 256, device=dev, generator=gen).to(
        torch.bfloat16) for _ in range(3)]
    y = att_core.attention_core(*args)
    ybar = torch.randn(512, 256, device=dev, generator=gen)
    ms = in_turns({
        "forward": lambda: att_core.attention_core(*args),
        "backward": lambda: att_core.attention_core_backward(*args, y, ybar),
        "plain": lambda: att_core.attention_core_plain(*args)})
    fwd_device = None if prof is None else sum(
        v for k, v in prof["kernel_ms"].items() if "att_core_kernel" in k)
    share = 2 * (ms["forward"] + ms["backward"]) / step_ms
    phase("time", f"attention core in the train step (E=512 C=256 bf16, "
          f"2 a step): kernel forward {ms['forward']} ms (on the device in "
          f"the step's profile: {fwd_device} ms a step), eager backward "
          f"{ms['backward']} ms, plain forward {ms['plain']} ms; "
          f"forward + backward {share:.4f} of the step ({card})")
    return {"train_step_ms": step_ms,
            "train_graphs_per_s": TRAIN_BATCH / step_ms * 1e3,
            "train_peak_memory_gib": peak,
            "train_busy_ms": None if prof is None else prof["busy_ms"],
            "train_idle_share": None if prof is None else prof["idle_share"],
            "train_forward_ms": ms["forward"],
            "train_backward_ms": ms["backward"],
            "train_forward_device_ms_per_step": fwd_device}


# ---------------------------------------------------------------------------
# time
# ---------------------------------------------------------------------------


def time_cached_eval(dev, model: RelPoseGNN, card: str) -> dict:
    """Attention core (kernel, its earlier form `v1`, `exp2_core`, plain
    version and the library call, in turns; the kernel's and `v1`'s time
    on the device alone) and the R3 cached eval step.  Returns the core's
    record at the main path's shape (E = 32 x batch 128, C = 256, bf16)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    core = {}
    v1 = functools.partial(att_variants.restructured_core, "v1")
    for e in (4096, 16384):
        for dtype in (torch.bfloat16, torch.float32):
            args = [torch.randn(e, 256, device=dev, generator=gen).to(dtype)
                    for _ in range(3)]
            check_library_core(args, att_core.attention_core_plain(*args),
                               f"E={e} C=256 {dtype}")
            ms = in_turns({
                "kernel": lambda: att_core.attention_core(*args),
                "v1": lambda: v1(*args),
                "exp2_core": lambda: att_variants.exp2_core(*args),
                "plain": lambda: att_core.attention_core_plain(*args),
                "library": lambda: library_core(*args)})
            ms["kernel_device"] = device_ms(
                lambda: att_core.attention_core(*args), "att_core_kernel")
            ms["v1_device"] = device_ms(lambda: v1(*args),
                                        "att_variant_kernel")
            check(ms["kernel"] < ms["v1"],
                  f"attention kernel ({ms['kernel']} ms) is not faster "
                  f"than its earlier form v1 ({ms['v1']} ms) at E={e} "
                  f"{dtype}")
            core[(e, dtype)] = ms
            phase("time", f"attention_core E={e} C=256 {str(dtype)[6:]}, in "
                  f"turns: kernel {ms['kernel']} ms, restructured_core/v1 "
                  f"(its earlier form) {ms['v1']} ms, exp2_core "
                  f"{ms['exp2_core']} ms, plain {ms['plain']} ms, library "
                  f"(scaled_dot_product_attention, head width 1) "
                  f"{ms['library']} ms; on the device alone (profiler): "
                  f"kernel {ms['kernel_device']} ms, v1 {ms['v1_device']} "
                  f"ms ({card})")
    e, c = 4096, 256
    bound = _util.bound_ms(att_variants.core_work(e, c, 2, None))
    phase("time", f"attention_core E={e} C={c} bf16 bound: "
          f"{bound['bound_ms']} ms by {bound['bound_by']} (ms by part: "
          f"{bound['parts']}; 3 inputs once and the output once at 3.35 "
          f"TB/s, E*C^2 exponentials at an estimated {_util.PEAK_EXP:.3e} "
          "exp/s = 16 a clock x 132 SMs x 1.98 GHz, 5 float32 operations "
          "per logit at 67 TFLOP/s)")
    phase("time", "SM clock while the attention kernel runs, and its "
          f"maximum (nvidia-smi clocks.sm, clocks.max.sm): "
          f"{sm_clock_under_load(lambda: att_core.attention_core(*args))}")

    rng = np.random.default_rng(SEED + 1)
    normalize = make_normalizer(MEAN, STD, dev)
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
                runs.append(median_ms(lambda: step(q, nbr_emb, poses,
                                                        adj)))
        else:
            runs.append(median_ms(lambda: step(q, nbr_emb, poses, adj)))
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    k_ms, p_ms = statistics.mean(runs[::3]), statistics.mean(runs[1:3])
    phase("time", f"R3 cached eval step, batch {BENCH_BATCH}, bf16, "
          f"{H}x{W}: kernel {runs[0]}/{runs[3]} ms = "
          f"{BENCH_BATCH / k_ms * 1e3} q/s; plain core "
          f"{runs[1]}/{runs[2]} ms = {BENCH_BATCH / p_ms * 1e3} q/s; "
          f"peak memory {peak} GiB ({card})")
    main_path = core[(4096, torch.bfloat16)]
    return {"ms": main_path["kernel"], "plain_ms": main_path["plain"],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": main_path["library"],
            "device_ms": main_path["kernel_device"],
            "v1_ms": main_path["v1"], "exp2_core_ms": main_path["exp2_core"]}


def time_variants(dev, card: str, bench_ms: dict) -> tuple:
    """Every attention-variant kernel at its bench entry's shape and on
    its bench entry's inputs (C = 256, float32; E = 32768 or 16384): the
    kernel's output against its plain version's (VARIANT_REL_TOL of
    max |y|), `v1 == base` bit for bit, the plain version and the library
    call timed in turns (median of 5; both materialise the [E, C, C]
    weights), and the bound.  The kernels' own times are the bench
    entries', `bench_ms`.  Returns ({form key: its record}, {form key:
    max abs err against the plain version at this shape})."""
    c = 256
    records, errs, outs = {}, {}, {}
    for key, (fn, form, _, entry) in VARIANT_FORMS.items():
        e = VARIANT_BENCH_E[entry]
        args = bench_att_core.att_inputs(e, c, dev)
        torch.cuda.empty_cache()
        got = fn(*args)
        want = att_variants.PLAIN[form](*args)
        scale = want.abs().max().item()
        errs[key] = (got - want).abs().max().item()
        check(bool(torch.isfinite(got).all())
              and errs[key] < VARIANT_REL_TOL * scale,
              f"{key} at E={e} C={c} float32: max abs err {errs[key]} "
              f"against its plain version (max |y| {scale})")
        check_library_core(args, want, f"E={e} C={c} float32")
        outs[key] = got
        del want
        ms = in_turns({"plain": lambda: att_variants.PLAIN[form](*args),
                       "library": lambda: library_core(*args)}, 5, 1)
        bound = _util.bound_ms(att_variants.core_work(e, c, 4, form))
        kernel, production = bench_ms[key]
        records[key] = {"ms": kernel, "production_kernel_ms": production,
                        "plain_ms": ms["plain"],
                        "bound_ms": bound["bound_ms"],
                        "bound_by": bound["bound_by"],
                        "library_ms": ms["library"], "shape": [e, c]}
        phase("time", f"{key} E={e} C={c} float32: kernel {kernel} ms in "
              f"its bench entry ({production / kernel:.3f}x the production "
              f"kernel's {production} ms beside it), plain {ms['plain']} "
              f"ms, library {ms['library']} ms, bound {bound['bound_ms']} "
              f"ms by {bound['bound_by']} ({bound['parts']}); max abs err "
              f"against plain {errs[key]:.3e} = {errs[key] / scale:.2e} of "
              f"max |y| ({card})")
    check(torch.equal(outs["restructured_core/v1"],
                      outs["restructured_core/base"]),
          "v1 differs from base at its bench shape: analytic and scanned "
          "row max must agree bit for bit")
    phase("time", "restructured_core v1 == base bit for bit at the bench "
          "shape")
    del outs
    torch.cuda.empty_cache()
    return records, errs


def time_multiscene(dev, ms: MultiSceneService, queries: dict,
                    card: str) -> None:
    """The multi-scene query step at batch 128, scenes in turns, device
    time; the request from host uint8; peak memory; bytes per scene."""
    q8 = {name: torch.from_numpy(q).to(dev) for name, q in queries.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.inference_mode():
        steps = in_turns({name: (lambda name=name: ms.query(name, q8[name],
                                                            3))
                          for name in q8})
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    first = next(iter(queries))
    host = _util.host_ms(lambda: ms.query(first, queries[first], 3), ITERS,
                         dev)
    per_scene = {name: sum(t.numel() * t.element_size()
                           for t in ms._scenes[name].as_tuple())
                 for name in q8}
    b = len(queries[first])
    phase("time", f"multi-scene query step, netvlad, stochastic, batch {b}, "
          f"bf16, {len(q8)} scenes at capacity "
          f"{ms.cfg.capacity}: "
          + ", ".join(f"{n} {v} ms = {b / v * 1e3} q/s"
                      for n, v in steps.items())
          + f"; request from host uint8 {host} ms (host clock); peak "
          f"memory {peak} GiB; bytes per scene {per_scene} ({card})")


def time_service(dev, svc: RelocalizationService, queries: np.ndarray,
                 card: str) -> None:
    """The query step at batch 128 and its stages, device time."""
    mode = svc.cfg.retrieval
    mean_t = torch.tensor(MEAN, device=dev)
    std_t = torch.tensor(STD, device=dev)

    def model_norm(x01):
        return (x01 - mean_t) / std_t

    q8 = torch.from_numpy(queries).to(dev)
    q01 = q8.float() / 255.0
    db = (svc.db_desc, svc.db_emb, svc.db_poses, svc.db_valid)
    sto = RelocalizationService(
        svc.model, svc.netvlad, dataclasses.replace(
            svc.cfg, deterministic=False))
    full = RelocalizationService(
        svc.model, svc.netvlad, dataclasses.replace(
            svc.cfg, deterministic=False, retrieval_candidates=None))
    with torch.inference_mode():
        if mode == "netvlad":
            q_desc = svc.netvlad(svc._netvlad_input(q01))
        else:
            q_desc = F.normalize(svc._encode(model_norm(q01))[:, 0],
                                 dim=-1)
        sim = similarities(q_desc, svc.db_desc)
        nbrs = svc._select(sim, svc.db_valid, 0)
        q_emb = svc._encode(model_norm(q01))
        table_bf16 = svc.db_desc.to(torch.bfloat16)
        adj = (~torch.eye(8, dtype=torch.bool, device=dev)).expand(
            len(q8), 8, 8)
        stages = {
            "encode (ResNet34)": lambda: svc._encode(model_norm(q01)),
            "rank, float32 table": lambda: similarities(q_desc,
                                                        svc.db_desc),
            "rank, bfloat16 table": lambda: similarities(q_desc,
                                                         table_bf16),
            "select, deterministic": lambda: svc._select(sim, svc.db_valid,
                                                         0),
            "select, stochastic window 256": lambda: sto._select(
                sim, svc.db_valid, 0),
            "select, stochastic full sort": lambda: full._select(
                sim, svc.db_valid, 0),
            "gather + GNN + anchor": lambda: serving.anchored_pose_step(
                svc.model, q_emb, svc.db_emb[nbrs], svc.db_poses[nbrs],
                adj),
        }
        if mode == "netvlad":
            stages = {"retrieval trunk (resize, VGG16, NetVLAD)":
                      lambda: svc.netvlad(svc._netvlad_input(q01)),
                      **stages}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        steps = in_turns({
            "deterministic": lambda: svc.query_with_db(db, q8, model_norm),
            "stochastic": lambda: sto.query_with_db(db, q8, model_norm, 3),
        })
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        parts = {name: median_ms(fn) for name, fn in stages.items()}
    # request time: host upload of the uint8 batch included, host clock
    host = _util.host_ms(lambda: svc.query_with_db(db, queries, model_norm),
                         ITERS, dev)
    b = len(q8)
    phase("time", f"service query step, {mode}, batch {b}, bf16, "
          f"{svc.db_count} frames in capacity {svc.db_desc.shape[0]}: "
          f"deterministic {steps['deterministic']} ms = "
          f"{b / steps['deterministic'] * 1e3} q/s; stochastic "
          f"{steps['stochastic']} ms = {b / steps['stochastic'] * 1e3} "
          f"q/s; request from host uint8 {host} ms "
          f"(host clock); peak memory {peak} GiB ({card})")
    for name, ms in parts.items():
        phase("time", f"  {mode} stage {name}: {ms} ms")
    profile_step(f"service query step, {mode}, stochastic, batch {b}",
                 lambda: sto.query_with_db(db, q8, model_norm, 3),
                 steps["stochastic"])


def time_pair_mlp(dev, card: str) -> dict:
    """Kernel on both bfloat16 routes, plain version and the two library
    forms, in turns, at E = 1024 and E = 16384 (B = 16, N = 8 and 32,
    every width 2048, bfloat16); the 'wgmma' kernel's time on the device
    alone.  Returns the record at the bench entry's shape, E = 1024."""
    record = {}
    dt = torch.bfloat16
    before = dict(pair_mlp.ROUTE_LAUNCHES)
    for n in (8, 32):
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        x, e, fc1k, fc1b, fc2k, fc2b = pair_mlp_inputs(
            dev, gen, 16, n, 2048, 2048, 2048, 2048, "edge", dt)
        ops = pair_mlp_operands(x, e, fc1k, fc1b, fc2k, fc2b, "edge", dt)
        fc1w, fc2w = fc1k.T.contiguous(), fc2k.T.contiguous()
        rows, d = ops["e"].shape[0], 2048
        with torch.inference_mode():
            ms = in_turns({
                "kernel": lambda: pair_mlp.fused_pair_mlp(**ops),
                "mma_sync": lambda: pair_mlp.fused_pair_mlp(
                    **ops, route="mma_sync"),
                "plain": lambda: pair_mlp.fused_pair_mlp_plain(**ops),
                "concat": lambda: bench_pair_mlp.concat_form(
                    x, e, fc1w, fc1b, fc2w, fc2b),
                "split": lambda: bench_pair_mlp.split_form(
                    x, e, fc1w, fc1b, fc2w, fc2b),
            }, iters=ITERS if n == 8 else 8)
            on_device = device_ms(lambda: pair_mlp.fused_pair_mlp(**ops),
                                  "pair_mlp_wgmma_kernel")
            memset = device_ms(lambda: pair_mlp.fused_pair_mlp(**ops),
                               "Memset")
        check(ms["kernel"] < ms["mma_sync"],
              f"pair MLP at E={rows}: the 'wgmma' route ({ms['kernel']} ms) "
              f"is not faster than 'mma_sync' ({ms['mma_sync']} ms)")
        flops = 2 * rows * 2048 * (2 * d + 2048 + 2048)
        moved = sum(t.numel() * t.element_size() for t in (
            ops["xs"], ops["e"], fc1k, fc1b, fc2k, fc2b)) + rows * 2048 * 4
        parts = _util.bound_ms({"bytes": moved, "bf16_ops": flops})
        bound, by = parts["bound_ms"], parts["bound_by"]
        flop_ms, bytes_ms = parts["parts"]["bf16"], parts["parts"]["bytes"]
        phase("time", f"fused_pair_mlp E={rows} D=De=H=Dout=2048 bf16, in "
              f"turns: kernel ('wgmma' route) {ms['kernel']} ms "
              f"({flops / ms['kernel'] / 1e9} TFLOP/s; on the device alone "
              f"{on_device} ms, and the memset of out before it {memset} "
              f"ms), 'mma_sync' "
              f"route {ms['mma_sync']} ms "
              f"({flops / ms['mma_sync'] / 1e9} TFLOP/s), plain "
              f"{ms['plain']} ms, library concat "
              f"{ms['concat']} ms, library split-weight {ms['split']} ms; "
              f"bound {bound} ms by {by} ({flops / 1e9} GFLOP at 989 "
              f"TFLOP/s = {flop_ms} ms; {moved / 1e6} MB at 3.35 TB/s = "
              f"{bytes_ms} ms) ({card})")
        if n == 8:
            record = {"ms": ms["kernel"], "plain_ms": ms["plain"],
                      "bound_ms": bound, "bound_by": by,
                      "library_ms": ms["concat"],
                      "library_split_ms": ms["split"],
                      "mma_sync_ms": ms["mma_sync"],
                      "device_ms": on_device}
    timed = {route: pair_mlp.ROUTE_LAUNCHES[route] - before[route]
             for route in before}
    check(timed["wgmma"] > 0 and timed["mma_sync"] > 0 and timed["fma"] == 0,
          f"time_pair_mlp launched {timed}")
    phase("time", f"fused_pair_mlp launches per route while timing: {timed}")
    return record


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    # cuBLAS reads it when its first handle is made: the train phase's
    # resume check runs with deterministic algorithms
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = _util.card_line()
    check(card is not None, "nvidia-smi gave no name and power limit")
    phase("device", f"{kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; TF32 off")
    print(card, flush=True)

    build_kernels()
    att_err = check_attention_kernel(dev)
    pair_err = check_pair_mlp_kernel(dev)
    variant_err = check_variant_kernels(dev)
    pair_launches = run_pair_mlp_bench()
    variant_launches, att_launches, variant_bench_ms = run_attention_benches()

    model = _synthetic.pose_model(dev, "R3", torch.bfloat16, SEED)
    sizes = ServiceSizes()
    with tempfile.TemporaryDirectory() as tmp:
        att_launches["evaluate_scene_cached"] = run_slice(dev, model, tmp)
    timed = {}
    with tempfile.TemporaryDirectory() as tmp:
        netvlad = _synthetic.netvlad_encoder(dev, 64, torch.bfloat16,
                                             SEED + 1)
        for mode in ("netvlad", "shared-trunk"):
            svc, queries, launches = exercise_service(dev, model, netvlad,
                                                      mode, sizes, tmp)
            att_launches[f"service {mode}"] = launches
            timed[mode] = (svc, queries)
        multi, multi_queries, launches = exercise_multiscene(
            dev, model, netvlad, sizes, tmp)
        att_launches["multi-scene service"] = launches
    run_service_benches()
    with tempfile.TemporaryDirectory() as tmp:
        att_launches["train"] = run_train(dev, tmp)
    att_launches["bench_train"] = run_bench_train()

    feed_sizes = FeedSizes()
    with tempfile.TemporaryDirectory() as feed_root:
        att_launches.update(run_feed(dev, feed_root, feed_sizes, {}))
        att_times = time_cached_eval(dev, model, card)
        att_times.update(time_train(dev, card))
        att_times.update(time_feed(dev, card, feed_root, feed_sizes, {}))
    variant_times, variant_bench_err = time_variants(dev, card,
                                                     variant_bench_ms)
    for mode, (svc, queries) in timed.items():
        time_service(dev, svc, queries, card)
    time_multiscene(dev, multi, multi_queries, card)
    pair_times = time_pair_mlp(dev, card)
    phase("done", f"every phase passed in {time.perf_counter() - t_start:.1f}"
          " s, the kernels' build included")

    print(json.dumps({"kernels": [
        {"name": "attention_core", "route": "cuda",
         "source": "relpose_gnn_tpu_torch/csrc/att_core.cu",
         "replaces": "relpose_gnn_tpu/ops/att_pallas.py:45",
         "launches": sum(att_launches.values()),
         "launches_by_path": att_launches, "max_abs_err": att_err,
         **att_times},
        {"name": "fused_pair_mlp", "route": "cuda",
         "source": "relpose_gnn_tpu_torch/csrc/pair_mlp.cu",
         "replaces": "relpose_gnn_tpu/ops/gnn_pallas.py:57",
         "launches": pair_launches,
         "launches_by_path": {"bench_pair_mlp.main": pair_launches},
         "route_launches": {
             "main_path": {"wgmma": pair_launches, "mma_sync": 0, "fma": 0},
             "whole_run": dict(pair_mlp.ROUTE_LAUNCHES)},
         "max_abs_err": pair_err, **pair_times},
        *({"name": key, "route": "cuda",
           "source": "relpose_gnn_tpu_torch/csrc/att_variants.cu",
           "replaces": replaces, "launches": variant_launches[key],
           "launches_by_path": {entry: variant_launches[key]},
           "max_abs_err": max(variant_err[key], variant_bench_err[key]),
           "bench_shape_max_abs_err": variant_bench_err[key],
           **variant_times[key]}
          for key, (_, _, replaces, entry) in VARIANT_FORMS.items())]}))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
