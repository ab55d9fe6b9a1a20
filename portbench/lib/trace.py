"""The traced run's instruments: wrappers that the benchmark puts around
calls into the program's layers, and the reading of the profiler's trace.

A wrapper is a patch in this process only: it replaces an attribute (a
module's function or an object's method) for the traced window and puts
the original back after it. It can time the call on the host clock
(after a device synchronise where the call itself does not end in one),
mark it as a profiler range (`record_function`), and record its shapes.
"""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import nullcontext

import torch

PREFIX = "portbench."


class Patches:
    """Wrappers applied together and removed together."""

    def __init__(self):
        self._undo = []
        self.seconds = defaultdict(float)     # host seconds inside each named call
        self.calls = defaultdict(int)
        self.records = defaultdict(list)      # what `record` kept, by name
        self.recording = False                # `record` keeps only while True

    def wrap(self, obj, attr: str, name: str, *, sync: bool = False, time_it: bool = True,
             record=None):
        orig = getattr(obj, attr)
        had = attr in getattr(obj, "__dict__", {})

        def wrapper(*args, **kwargs):
            if record is not None and self.recording:
                self.records[name].append(record(*args, **kwargs))
            with torch.profiler.record_function(PREFIX + name):
                t0 = time.perf_counter() if time_it else 0.0
                out = orig(*args, **kwargs)
                if time_it:
                    if sync:
                        torch.cuda.synchronize()
                    self.seconds[name] += time.perf_counter() - t0
                    self.calls[name] += 1
            return out

        setattr(obj, attr, wrapper)
        self._undo.append((obj, attr, orig, had))

    def remove(self):
        for obj, attr, orig, had in reversed(self._undo):
            if had or not hasattr(type(obj), attr):
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo.clear()


class Profile:
    """torch.profiler over part of the window (CPU and CUDA activity),
    with one range marking it, read after it stops."""

    def __init__(self, enabled: bool):
        self.prof = None
        self.stopped = False
        self.enabled = enabled
        self._mark = nullcontext()

    def start(self):
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._mark = torch.profiler.record_function(PREFIX + "window")
        self._mark.__enter__()

    def stop(self):
        """Stop tracing; the trace is read later (`read_trace`), after the
        window."""
        if self.prof is None or self.stopped:
            return
        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.stopped = True

    def read_trace(self):
        return None if self.prof is None else read(self.prof.profiler.kineto_results.events())


def _union(intervals):
    total, end = 0, None
    merged = []
    for a, b in sorted(intervals):
        if end is None or a > end:
            merged.append([a, b])
            end = b
        elif b > end:
            merged[-1][1] = b
            end = b
    for a, b in merged:
        total += b - a
    return total, merged


def innermost(ranges, times):
    """For each time, the name of the innermost range (start, end, name)
    that holds it, or None; ranges nest, as a thread's ranges do."""
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = [None] * len(times)
    spans = sorted(ranges)
    stack, j = [], 0
    for i in order:
        t = times[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def read(events) -> dict:
    """What the metrics take from a trace: the window (the
    'portbench.window' range), the device's busy seconds in it (the union
    of every device record), device seconds by kernel name, device seconds
    of the kernels launched inside each benchmark range, and the idle gaps
    labelled by the innermost benchmark range the host was in."""
    win = None
    ranges = []           # (start, end, name) of benchmark ranges
    launches = []         # (start, correlation) of runtime calls
    device = []           # (start, end, name, correlation)
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if name.startswith(PREFIX):
                continue                  # a benchmark range mirrored on the device's timeline
            start = e.start_ns()
            link = e.linked_correlation_id() or e.correlation_id()
            device.append((start, start + e.duration_ns(), name, link))
        elif name == PREFIX + "window":
            win = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif name.startswith(PREFIX):
            ranges.append((e.start_ns(), e.start_ns() + e.duration_ns(), name[len(PREFIX):]))
        elif name.startswith("cuda") or name.startswith("cu"):
            launches.append((e.start_ns(), e.correlation_id()))
    if win is None:
        return {}
    w0, w1 = win
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    busy, merged = _union([(max(a, w0), min(b, w1)) for a, b, _, _ in device])
    by_name = defaultdict(float)
    for a, b, name, _ in device:
        by_name[name] += (b - a) / 1e9

    corr_range = dict(zip((c for _, c in launches),
                          innermost(ranges, [t for t, _ in launches])))
    in_range = defaultdict(lambda: defaultdict(float))
    for a, b, name, corr in device:
        r = corr_range.get(corr)
        if r is not None:
            in_range[r][name] += (b - a) / 1e9

    holes, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    gaps = defaultdict(float)
    for (a, b), label in zip(holes, innermost(ranges, [(a + b) // 2 for a, b in holes])):
        gaps[label or "host"] += (b - a) / 1e9
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9, "by_name": dict(by_name),
            "in_range": {k: dict(v) for k, v in in_range.items()}, "idle_by_range": dict(gaps)}


def breakdown(trace: dict) -> dict:
    top = sorted(trace.get("by_name", {}).items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(trace.get("idle_by_range", {}).items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in idle]}
