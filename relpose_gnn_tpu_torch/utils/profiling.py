"""Profiling: a windowed step timer and `torch.profiler` traces.

Port of `relpose_gnn_tpu/utils/profiling.py`: `StepTimer` measures
steady-state steps per second and waits for the device only at window
boundaries (where the JAX timer calls `block_until_ready`), and `trace`
records a `torch.profiler` trace (CPU activity, and CUDA activity where
there is a card) of the block it wraps into a Chrome trace file in its
directory, for TensorBoard or Perfetto.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch
from torch.utils._pytree import tree_leaves


def _wait_for(value) -> None:
    """Wait for every CUDA device that holds a tensor of `value` (a
    tensor or a tree of them)."""
    devices = {leaf.device for leaf in tree_leaves(value)
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


@dataclass
class StepTimer:
    """Windowed steady-state throughput measurement."""

    window: int = 50
    _t0: float = field(default=0.0, init=False)
    _count: int = field(default=0, init=False)
    last_steps_per_sec: float = field(default=0.0, init=False)

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._count = 0

    def step(self, sync_value=None) -> float | None:
        """Call once a step; returns steps/s at window boundaries, None
        between them.

        `sync_value`: a tensor (or a tree of them) the step produced; at a
        boundary its devices are waited for, so the window covers the
        device's work and not only its launch."""
        self._count += 1
        if self._count % self.window:
            return None
        if sync_value is not None:
            _wait_for(sync_value)
        now = time.perf_counter()
        self.last_steps_per_sec = self.window / (now - self._t0)
        self._t0 = now
        return self.last_steps_per_sec


@contextlib.contextmanager
def trace(logdir: str | None):
    """`with trace('/tmp/trace'):` records a profiler trace of the block
    into `<logdir>/<host>_<pid>.<ns>.pt.trace.json`; does nothing when
    logdir is None."""
    if logdir is None:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                logdir)):
        yield
