"""Shared plumbing of the port's benches: timing, the card's peaks, bounds.

Counterpart of the JAX package's `benchmarks/_util.py`.  One copy on
purpose: every bench and `chip_smoke.py` time through these functions.

Timing on the card is by CUDA events around each call, after warm-up, as a
median; forms that are compared are timed in turns within one process
(a, b, c, c, b, a), so that drift of the card's clocks falls on all alike.
On the CPU (asked for with `--device cpu`, as the tests do) the host clock
stands in; such a number says nothing about the card.

The peaks are NVIDIA's published ones for the H100 SXM (dense, at the full
700 W power limit); `card_line()` gives the name and power limit that every
kept number is written beside.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from unittest import mock

import torch

from relpose_gnn_tpu_torch.ops import att_core

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_FP32 = 67e12
# exponentials per second: 16 per SM per clock x 132 SMs x 1.98 GHz; an
# estimate of the special-function rate, which no data sheet states
PEAK_EXP = 16 * 132 * 1.98e9


def card_line() -> str | None:
    """The card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them; None
    where there is no such tool (a CPU run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def device_record(device: torch.device) -> dict:
    """What ran the bench: the platform, the device's name and, on a
    card, the `nvidia-smi` line."""
    if device.type == "cuda":
        return {"platform": "gpu",
                "device": torch.cuda.get_device_name(device),
                "card": card_line()}
    return {"platform": device.type, "device": device.type, "card": None}


def median_ms(fn, iters: int = 20, warmup: int = 3,
              device: torch.device | str = "cuda") -> float:
    """Median over `iters` calls of fn's time in ms: device time by CUDA
    events on a card, the host clock elsewhere."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    times = []
    if device.type != "cuda":
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def in_turns(forms: dict, iters: int = 20, warmup: int = 3,
             device: torch.device | str = "cuda") -> dict:
    """Median ms of each form, timed forwards then backwards (a, b, c, c,
    b, a); the mean of each form's two medians."""
    names = list(forms)
    runs = {n: [] for n in names}
    for n in names + names[::-1]:
        runs[n].append(median_ms(forms[n], iters, warmup, device))
    return {n: statistics.mean(v) for n, v in runs.items()}


def turn_calls(iters: int, warmup: int = 3) -> int:
    """How often `in_turns` calls each of its forms."""
    return 2 * (iters + warmup)


def host_ms(fn, iters: int, device: torch.device) -> float:
    """Median host-clock ms of fn, synchronised before and after each
    call: a request's time as its sender sees it."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    times = []
    for _ in range(iters):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def count_flops(fn) -> int:
    """Floating-point operations of one call of fn: matrix products and
    convolutions as `torch.utils.flop_counter.FlopCounterMode` counts them
    (2 per multiply-add), and 3·E·C² for each call of the attention core
    (`att_core.FLOPS`, the TPU kernel's own cost estimate, which the JAX
    package's count reads too).  FlopCounterMode cannot see into the
    kernel; on the CPU, where the core's plain version runs instead, what
    it sees of that version is left out, so that the count is the same on
    either device.  Other elementwise work is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    plain = att_core.attention_core_plain
    unseen = 0

    def plain_unseen(*args):
        nonlocal unseen
        before = counter.get_total_flops()
        out = plain(*args)
        unseen += counter.get_total_flops() - before
        return out

    tally = att_core.FLOPS
    with FlopCounterMode(display=False) as counter, mock.patch.object(
            att_core, "attention_core_plain", plain_unseen):
        fn()
    return int(counter.get_total_flops() - unseen + att_core.FLOPS - tally)


def mfu(flops: int, ms: float, device: torch.device) -> float | None:
    """Achieved FLOP/s over the H100's dense bf16 peak; None off the
    card, where the peak means nothing."""
    if device.type != "cuda" or not flops or ms <= 0:
        return None
    return flops / (ms * 1e-3) / PEAK_BF16


def peak_memory_gib(device: torch.device) -> float | None:
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 30


def reset_peak_memory(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def bound_ms(work: dict) -> dict:
    """The least time the card could take for `work` = {bytes,
    exponentials, fp32_ops, tf32_ops, bf16_ops} (missing keys are 0): the
    largest of the bytes over the memory rate and each kind of operation
    over its peak.  Returns {bound_ms, bound_by, parts}."""
    parts = {
        "bytes": work.get("bytes", 0) / PEAK_BYTES * 1e3,
        "exponentials": work.get("exponentials", 0) / PEAK_EXP * 1e3,
        "fp32": work.get("fp32_ops", 0) / PEAK_FP32 * 1e3,
        "tf32": work.get("tf32_ops", 0) / PEAK_TF32 * 1e3,
        "bf16": work.get("bf16_ops", 0) / PEAK_BF16 * 1e3,
    }
    worst = max(parts, key=parts.get)
    return {"bound_ms": parts[worst],
            "bound_by": "bytes" if worst == "bytes" else "operations",
            "parts": parts}


def emit(record: dict, path: str | None = None) -> None:
    """Print `record` as one JSON line and, where `path` is given, write
    it there too."""
    print(json.dumps(record), flush=True)
    if path:
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
