"""Spans around the calls into each layer, and the profiler trace of the
device, reduced to what the per-layer readers need.

Spans are recorded only in a traced run (``--trace 1``), on the host
clock, and mirrored into the profiler's trace by ``record_function`` so
that device work can be attributed to the span that launched it (by the
launch's correlation id).  Names start with ``prog.`` around a call into
the program and with ``bench.`` around the benchmark's own work.
"""

from __future__ import annotations

import contextlib
import time

import torch

#: host-side runtime calls that put work on the device
_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
             "cudaMemcpyAsync", "cudaMemsetAsync", "cudaMemcpy",
             "cudaMemset", "cuLaunchKernelEx", "cudaGraphLaunch")
_PREFIXES = ("prog.", "bench.")
#: the span around the measured window
WINDOW = "bench.window"
#: entries of each breakdown list
TOP = 10


class Spans:
    """Named host-clock intervals; a no-op unless `enabled`."""

    def __init__(self, enabled, sync=None):
        self.enabled = bool(enabled)
        self.sync = sync
        self.items = []

    @contextlib.contextmanager
    def __call__(self, name, sync=False):
        """Record `name` around the block; with `sync`, the block's device
        work is waited for before the span closes."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            if sync and self.sync is not None:
                self.sync()
        self.items.append((name, t0, time.perf_counter()))

    def durations(self, name):
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


class Profile:
    """torch.profiler over the measured window (CPU and, with a card,
    CUDA activity); ``reduce()`` gives a Trace."""

    def __init__(self, cuda):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def reduce(self):
        return Trace(self.prof.profiler.kineto_results.events(), WINDOW)


def _union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Trace:
    """Device operations (name, start, end, launching span) and host spans
    of one traced window, times in ns on the profiler's clock."""

    def __init__(self, events, window):
        ops, launches, spans = [], {}, []
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not name.startswith(_PREFIXES):
                    ops.append((name, e.start_ns(),
                                e.start_ns() + e.duration_ns(),
                                e.correlation_id()))
            elif name.startswith(_PREFIXES):
                spans.append((name, e.start_ns(),
                              e.start_ns() + e.duration_ns()))
            elif name in _LAUNCHES:
                launches[e.correlation_id()] = e.start_ns()
        wins = [(s, t) for n, s, t in spans if n == window]
        self.window = wins[0] if wins else None
        w0, w1 = self.window or (0, 0)
        self.spans = [x for x in spans if x[0] != window]
        owner = self._owners(sorted(launches.items(), key=lambda kv: kv[1]))
        self.ops = [(n, max(s, w0), min(t, w1), owner.get(c))
                    for n, s, t, c in ops if t > w0 and s < w1]

    def _owners(self, launches):
        """correlation id -> innermost span open at its launch."""
        marks = sorted([(s, 0, i) for i, (_, s, _) in enumerate(self.spans)]
                       + [(t, 1, i) for i, (_, _, t) in enumerate(self.spans)])
        out, stack, j = {}, [], 0
        for corr, t in launches:
            while j < len(marks) and marks[j][0] <= t:
                _, kind, i = marks[j]
                if kind == 0:
                    stack.append(i)
                elif i in stack:
                    stack.remove(i)
                j += 1
            if stack:
                out[corr] = self.spans[stack[-1]][0]
        return out

    @property
    def window_s(self):
        return 0.0 if self.window is None else (
            self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self):
        return _union([(s, t) for _, s, t, _ in self.ops]) * 1e-9

    def kernel_time(self, substring):
        """(seconds, launches) of device ops whose name holds
        `substring`."""
        hit = [t - s for n, s, t, _ in self.ops if substring in n]
        return sum(hit) * 1e-9, len(hit)

    def span_device_time(self, span, exclude=None):
        """Seconds of device ops launched inside span `span`, leaving out
        those whose name holds `exclude`."""
        return sum(t - s for n, s, t, o in self.ops
                   if o == span and not (exclude and exclude in n)) * 1e-9

    def breakdown(self):
        """The device ops that took most time, and the device's idle time
        split by the innermost span the host was in meanwhile ("host"
        outside every span)."""
        by = {}
        for n, s, t, _ in self.ops:
            by[n[:160]] = by.get(n[:160], 0) + (t - s)
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        idle = {}
        if self.window is not None:
            segs = iter(self._segments())
            seg = next(segs, None)
            for a, b in self._gaps():
                while seg is not None and seg[1] <= a:
                    seg = next(segs, None)
                while seg is not None and seg[0] < b:
                    lo, hi = max(a, seg[0]), min(b, seg[1])
                    if hi > lo:
                        idle[seg[2]] = idle.get(seg[2], 0) + (hi - lo)
                    if seg[1] > b:
                        break
                    seg = next(segs, None)
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, v * 1e-9] for n, v in ops],
                "idle_gaps": [[n, v * 1e-9] for n, v in gaps]}

    def _gaps(self):
        """The window's intervals with no device op, in order."""
        prev, out = self.window[0], []
        for s, t in sorted((s, t) for _, s, t, _ in self.ops):
            if s > prev:
                out.append((prev, s))
            prev = max(prev, t)
        if self.window[1] > prev:
            out.append((prev, self.window[1]))
        return out

    def _segments(self):
        """The window cut into (start, end, innermost open span), in
        order."""
        marks = sorted([(s, 1, i) for i, (_, s, _) in enumerate(self.spans)]
                       + [(t, 0, i) for i, (_, _, t) in enumerate(self.spans)])
        out, stack, prev = [], [], self.window[0]
        for t, kind, i in marks:
            t = min(max(t, self.window[0]), self.window[1])
            label = self.spans[stack[-1]][0] if stack else "host"
            if t > prev:
                out.append((prev, t, label))
                prev = t
            if kind == 1:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        if self.window[1] > prev:
            out.append((prev, self.window[1], "host"))
        return out
