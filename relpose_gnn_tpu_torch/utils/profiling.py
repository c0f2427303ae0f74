"""Profiling: a windowed step timer, `torch.profiler` traces, and the
port's spans.

Port of `relpose_gnn_tpu/utils/profiling.py`: `StepTimer` measures
steady-state steps per second and waits for the device only at window
boundaries (where the JAX timer calls `block_until_ready`), and `trace`
records a `torch.profiler` trace (CPU activity, and CUDA activity where
there is a card) of the block it wraps into a Chrome trace file in its
directory, for TensorBoard or Perfetto.

`span(name)` marks one stage of the main path as a profiler range named
`relpose.<name>`.  It records whenever a profiler records (`trace`, a
benchmark's traced stretch, any `torch.profiler` window) and costs one
check of the profiler's state otherwise; there is no switch.  The ranges
land in the profiler's own trace beside the device's kernels and copies,
on the same clock, and each device op belongs to the spans its launch
fell in on the host.  The spans:

    service.query       one batch's whole host enqueue (`query_with_db`)
      service.upload    the batch's host-to-device copy
      service.descriptor  the retrieval descriptor: the NetVLAD pass
                        (its input's resize is the query's own), or the
                        normalised embedding in shared-trunk mode
      service.encode    the query's node embedding
      service.rank      the similarities (the sharded top-C and lookup
                        on a sharded table)
      service.select    the neighbour selection
        select.window_read  the host read of the window check
        select.full_sort    the full sort after a window shortfall
      service.gather    the neighbours' embeddings and poses, the graph
      service.gnn       the GNN and the anchored pose
    stream.fetch        one result's read-back to the host
    feed.gather         one batch gathered from a store on the device
    train.step          one train step
      train.forward     forward and loss
      train.backward    the backward (its kernels launch from autograd's
                        thread, inside this span's time)
      train.optimizer   the Adam update

Spans carry no batch index.  Every `service.*` and `select.*` span of a
batch nests inside its `service.query`; `stream.fetch` runs later, once
the stream holds `depth` batches, and the stream is first in, first
out, so the n-th `stream.fetch` of a stream answers its n-th
`service.query`.
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


SPAN_PREFIX = "relpose."
_OFF = contextlib.nullcontext()
# bound once: a span with no profiler running is this call and a return
_profiler_enabled = torch.autograd._profiler_enabled


def span(name: str):
    """`with span("service.rank"):` a profiler range `relpose.<name>`
    around the block while a profiler records; otherwise one shared
    no-op context, and no range is entered."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)
