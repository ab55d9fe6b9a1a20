"""The port's tracing: named spans and counters around the serving path's
work, and the torch.profiler trace behind CHATTERBOX_PROFILE_DIR.

- `span(name, **ids)` is a context manager. Off (the default) it returns
  one shared no-op context: a flag read, no clock read, nothing made. On,
  it stamps its start and end with `time.perf_counter_ns()`, keeps
  `(name, parent, start_ns, end_ns, ids)` in a list of at most MAX_SPANS
  (the oldest dropped), and running totals by name: calls, ns and self ns
  (the ns that no child span covers). While a torch.profiler records, the
  span is also the range "chatterbox.<name>" on the profiler's timeline.
  Spans nest per thread; `ids` name what a span worked on (a request id).
- `count(name, n=1)` adds to a running total while on.
- Device counters (`device_add(name, value)`): int64 tensors on the
  device, added to on the device while on (with the spans, or alone after
  `enable_device_counters()`, which leaves the spans off), so that code
  captured into a CUDA graph counts at every replay: the adds are captured
  only when they are on at capture, and cost nothing otherwise. A counter is made
  at its first add, which must not be inside a capture. `totals()` folds
  them into its counters with one copy to the host; `reset()` zeroes them
  in place, since a graph holds their addresses. The backbones' counters,
  added once a forward: `moe.calls`, `moe.assignments`,
  `moe.experts_touched`, `moe.max_expert_rows` (the held routed experts,
  models/deepseek_v2.py); `kda.calls`, `kda.tokens` (row-tokens through
  K9), `kda.states_read`, `kda.states_written` ((row, head) states;
  models/kimi_linear.py).
- The backbones' spans around their eager layers: `dsv2.attention`,
  `dsv2.route`, `dsv2.experts`, and `kimi.kda` (a KDA layer).
- `enable()`, `disable()`, `reset()`, `totals()`, `spans()`.
- One clock with the device trace: torch.profiler (Kineto) stamps host
  events in Unix ns. `enable()` takes `offset_ns = time.time_ns() -
  time.perf_counter_ns()` once, and `spans()` gives `perf_counter_ns +
  offset_ns`, so every span, in a profiled window or not, lies on the
  trace's timeline.
- `trace(name, log_dir)`: torch.profiler over the block with spans on, the
  program's spans among its ranges.

No span goes inside code captured into a CUDA graph: it would record at
capture only; device counters do. Device times of kernels are measured with
`probes/timing.py`, not here.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterator, List, Optional

import torch
from torch.profiler import record_function

MAX_SPANS = 1 << 20
RANGE_PREFIX = "chatterbox."

_on = False
_device_on = False
_offset_ns = 0
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_spans: deque = deque(maxlen=MAX_SPANS)
_totals: Dict[str, List[int]] = {}           # name -> [calls, ns, self ns]
_counters: Dict[str, int] = defaultdict(int)
_device: Dict[str, torch.Tensor] = {}        # name -> int64 counter on the device


class _Span:
    __slots__ = ("name", "ids", "parent", "start", "child_ns", "range")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self.range = None
        self.start = time.perf_counter_ns()
        if torch.autograd._profiler_enabled():
            # the span holds its range: the trace's range opens after start
            self.range = record_function(RANGE_PREFIX + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.perf_counter_ns()
        _local.stack.pop()
        ns = end - self.start
        parent = self.parent
        with _lock:
            t = _totals.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += ns
            t[2] += ns - self.child_ns
            if parent is not None:
                parent.child_ns += ns
            _spans.append((self.name, None if parent is None else parent.name,
                           self.start + _offset_ns, end + _offset_ns, self.ids))
        return False


def span(name: str, **ids):
    """The span `name` around a `with` block (module docstring)."""
    if not _on:
        return _OFF
    return _Span(name, ids)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while spans are on."""
    if _on:
        with _lock:
            _counters[name] += n


def device_counting() -> bool:
    """Whether device counters are added to now."""
    return _on or _device_on


def enable_device_counters(on: bool = True) -> None:
    """Turn the device counters on (or off) without the spans."""
    global _device_on
    _device_on = on


def device_add(name: str, value: torch.Tensor) -> None:
    """Add `value` (a 0-dim integer tensor) to the device counter `name` on
    the device, while on. The counter is made on value's device at its
    first add, which raises inside a CUDA graph capture."""
    if not device_counting():
        return
    t = _device.get(name)
    if t is None:
        if value.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"device counter {name!r} first added inside a CUDA graph "
                               "capture: add to it once eagerly first")
        t = _device[name] = torch.zeros((), dtype=torch.int64, device=value.device)
    t.add_(value.to(torch.int64))


def enable() -> None:
    """Turn spans and counters on, and take the offset that puts
    perf_counter_ns on the profiler's Unix clock."""
    global _on, _offset_ns
    _offset_ns = time.time_ns() - time.perf_counter_ns()
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Drop every kept span, total and counter."""
    with _lock:
        _spans.clear()
        _totals.clear()
        _counters.clear()
        for t in _device.values():
            t.zero_()


def totals() -> dict:
    """{"spans": {name: {"calls", "ns", "self_ns"}}, "counters": {name: n}}
    since the last reset; the device counters read with one copy to the
    host."""
    names = list(_device)
    values = []
    if names:
        dev = _device[names[0]].device
        values = torch.stack([_device[k].to(dev) for k in names]).tolist()
    with _lock:
        counters = dict(_counters)
        # a device counter at zero is left out, as a host counter never added to
        counters.update((k, v) for k, v in zip(names, values) if v)
        return {"spans": {k: {"calls": c, "ns": ns, "self_ns": s}
                          for k, (c, ns, s) in _totals.items()},
                "counters": counters}


def spans() -> list:
    """The kept spans, oldest first: (name, parent name or None, start_ns,
    end_ns, ids), the stamps on the profiler's Unix clock."""
    with _lock:
        return list(_spans)


@contextlib.contextmanager
def trace(name: str = "chatterbox", log_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler trace of the block, gated by `log_dir` or
    CHATTERBOX_PROFILE_DIR: the host's activity, and the card's when one is
    present, with spans on and the block itself the span `name`, written
    as a Chrome trace `<name>-<pid>-<ns>.pt.trace.json` in that directory
    (open it in Perfetto or chrome://tracing)."""
    log_dir = log_dir or os.getenv("CHATTERBOX_PROFILE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _on
    enable()
    try:
        with profile(activities=activities) as prof:
            with span(name):
                yield
    finally:
        if not was_on:
            disable()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{name}-{os.getpid()}-{time.time_ns()}.pt.trace.json"))
