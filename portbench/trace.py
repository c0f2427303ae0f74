"""One bounded stretch of `torch.profiler` inside the measured window, and
what the harness reads from it.

`Tracer` runs the profiler over `active` steps after `wait` steps of the
window, so the traced run records a few thousand device launches
whatever the window's length: after one window per process torch's
profiler is known to stop recording some 50,000 launches later.
Ranges are the harness's own: `torch.profiler.record_function` around a
module's forward (its pre- and post-hooks) or an optimizer's step (its
step hooks), opened only in a traced run.

`Trace` is the stretch as read from the exported Chrome trace: kernels,
copies and memsets on the device, the host's launch calls (their
correlation ids tie each launch to its device op) and the harness's
ranges.  Times are seconds.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

RANGE_PREFIX = "portbench."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _clip(intervals, lo, hi) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in intervals)


class Trace:
    """The recorded stretch.  `window` = (start, end): from the first
    event recorded (host or device) to the last one's end; the profiler
    records only during the active steps."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]

        def span(e):
            s = float(e["ts"]) * 1e-6
            return s, s + float(e.get("dur", 0.0)) * 1e-6

        self.device = [(e.get("cat"), e.get("name", ""), *span(e),
                        (e.get("args") or {}).get("correlation"))
                       for e in xs if e.get("cat") in _DEVICE_CATS]
        self.launch = {}
        for e in xs:
            if e.get("cat") in _LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    self.launch[corr] = span(e)[0]
        self.host = [(e.get("name", ""), *span(e), e.get("cat"))
                     for e in xs if e.get("cat") in
                     ("cpu_op", "user_annotation", "cuda_runtime",
                      "cuda_driver")]
        spans = [(h[1], h[2]) for h in self.host] + [(d[2], d[3])
                                                     for d in self.device]
        self.window = (min((s for s, _ in spans), default=0.0),
                       max((t for _, t in spans), default=0.0))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> list:
        return [d for d in self.device if d[0] == "kernel"]

    def busy_s(self, kernels_only: bool = False) -> float:
        ops = self.kernels() if kernels_only else self.device
        return _clip(_union((d[2], d[3]) for d in ops), *self.window)

    def device_ops_by_name(self) -> dict:
        out: dict = {}
        for cat, name, s, e, _ in self.device:
            key = name if cat == "kernel" else f"[{cat}] {name}"
            out[key] = out.get(key, 0.0) + e - s
        return out

    def kernel_calls(self, substring: str) -> list:
        """Device seconds of each kernel whose name holds `substring`."""
        return [d[3] - d[2] for d in self.kernels() if substring in d[1]]

    def range_device_s(self, name: str) -> tuple[float, int] | None:
        """(device seconds of the kernels launched inside the harness's
        range `name`, over all its instances; the number of instances),
        or None where the stretch holds no such range."""
        full = RANGE_PREFIX + name
        spans = [(s, t) for n, s, t, c in self.host
                 if c == "user_annotation" and n == full]
        if not spans:
            return None
        spans.sort()
        total = 0.0
        starts = [s for s, _ in spans]
        for cat, _, s, e, corr in self.device:
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
        return total, len(spans)

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps in the window with no device op, each named by
        what the host was doing at its middle: the innermost host event
        there (a launch or sync call, an op, a range)."""
        busy = _union((d[2], d[3]) for d in self.device)
        lo, hi = self.window
        gaps, cur = [], lo
        for s, e in busy:
            if s > cur:
                gaps.append((cur, min(s, hi)))
            cur = max(cur, e)
        if cur < hi:
            gaps.append((cur, hi))
        gaps = sorted((g for g in gaps if g[1] > g[0]),
                      key=lambda g: g[0] - g[1])[:top]
        out = []
        for s, e in gaps:
            mid = 0.5 * (s + e)
            inner = [(t - a, n) for n, a, t, c in self.host
                     if a <= mid <= t and not n.startswith("ProfilerStep#")]
            out.append([min(inner)[1] if inner else "host: no event recorded",
                        e - s])
        return out


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        return Trace(json.load(f).get("traceEvents", []))


class Tracer:
    """The profiler over steps [wait, wait + active) of a window when
    `enabled`; a no-op otherwise.  Call `step()` once a step (a served
    batch, a train step): the profiler starts after the `wait`-th call and
    stops after `active` more, with no schedule (one plain window).
    `trace` holds the `Trace` once the tracer's block has ended (the
    export runs then, outside the measured window)."""

    def __init__(self, enabled: bool, wait: int, active: int):
        self.enabled, self.wait, self.active = enabled, wait, active
        self.trace: Trace | None = None
        self.steps_recorded = 0
        self._prof = self._done = None
        self._hooks: list = []
        self._open: dict = {}
        self._n = 0

    def __enter__(self):
        self._n = 0
        if self.enabled and self.wait == 0:
            self._start()
        return self

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()

    def _stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._done, self._prof = self._prof, None
        self._done.__exit__(None, None, None)

    def _export(self) -> None:
        """Read the stopped profiler's trace (after the window: exporting
        takes seconds)."""
        prof, self._done = self._done, None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            self.trace = read_chrome_trace(path)
        finally:
            os.remove(path)

    def step(self) -> None:
        if not self.enabled or self._done is not None:
            return
        self._n += 1
        if self._prof is not None:
            self.steps_recorded += 1
            if self.steps_recorded == self.active:
                self._stop()
        elif self._n == self.wait:
            self._start()

    def __exit__(self, *exc):
        if self._prof is not None:
            self._stop()
        if self._done is not None:
            self._export()
        for h in self._hooks:
            h.remove()
        self._hooks = []
        return False

    def range(self, name: str):
        """A harness range around a block of host code."""
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(RANGE_PREFIX + name)

    def hook_module(self, module, name: str) -> bool:
        """A range named `name` around every forward of `module` (if it is
        an nn.Module).  Returns whether the hook point exists."""
        import torch
        if not isinstance(module, torch.nn.Module):
            return False
        if not self.enabled:
            return True
        self._hooks += [module.register_forward_pre_hook(self._opener(name)),
                        module.register_forward_hook(self._closer(name))]
        return True

    def hook_optimizer(self, optimizer, name: str) -> bool:
        """A range named `name` around every `step()` of a torch.optim
        optimizer.  Returns whether the hook point exists."""
        import torch
        if not isinstance(optimizer, torch.optim.Optimizer):
            return False
        if not self.enabled:
            return True
        self._hooks += [
            optimizer.register_step_pre_hook(self._opener(name)),
            optimizer.register_step_post_hook(self._closer(name))]
        return True

    def _opener(self, name):
        def pre(obj, *args, **kwargs):
            rf = self.range(name)
            rf.__enter__()
            self._open.setdefault((id(obj), name), []).append(rf)
        return pre

    def _closer(self, name):
        def post(obj, *args, **kwargs):
            stack = self._open.get((id(obj), name))
            if stack:
                stack.pop().__exit__(None, None, None)
        return post
