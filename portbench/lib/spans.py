"""The program's own spans (`chatterbox_embed_tpu_torch/utils/profiling.py`)
read from a traced window, beside what `trace.read` takes from it.

While a profiler records, each program span is also a host range
"chatterbox.<name>", which the profiler mirrors onto the device's
timeline. `without_program_ranges` drops those mirrors, so that
`trace.read` counts only kernels, copies and memsets as busy. `read` gives,
over the 'portbench.window' range:

- `idle_by_span`: the device's idle gaps, each labelled by the innermost
  program range the host was in at the gap's midpoint (`trace.read`'s rule
  for benchmark ranges), "host" outside every program range;
- `launches_by_span`: the host's runtime calls that enqueue work on the
  card, by the innermost program range they were made in; a graph launch
  counts one;
- `span_count`: the program ranges that started in the window, by name.

`dispatch_launches` counts the launches of each vocode dispatch and joins
its range to the program's own record of the span (`profiling.spans()`,
stamped on the trace's clock) for the ids the range does not carry: its
rows and its solver setting.

`metrics` reads the per-layer numbers of the engine and the vocode flush
from these and from the spans' and counters' growth (`run`).
"""
from __future__ import annotations

import re
from collections import defaultdict

import torch

from .trace import PREFIX, _union, innermost

PROGRAM = "chatterbox."
LAUNCH = re.compile(r"^(cudaLaunchKernel\w*|cuLaunchKernel\w*|cudaGraphLaunch|"
                    r"cudaMemcpy\w*Async|cudaMemsetAsync)$")
OUTSIDE = "host"
SR = 24_000

ENGINE_BLOCK = ("engine.block", "engine.done_read", "engine.sample", "engine.noise",
                "engine.forward", "engine.fetch")
VOCODE = ("server.vocode", "s3gen.prepare", "s3gen.dispatch", "s3gen.encoder", "s3gen.cfm",
          "s3gen.hift", "s3gen.fetch")
DISPATCH = "s3gen.dispatch"
JOIN_NS = 1_000_000          # a span's stamp against its range's: within 1 ms
ROOTS = ("engine.step", "server.pump")


def _on_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def without_program_ranges(events) -> list:
    """The events less the program ranges' mirrors on the device's timeline."""
    return [e for e in events if not (_on_device(e) and e.name().startswith(PROGRAM))]


def read(events) -> dict:
    win, ranges, launches, device = None, [], [], []
    for e in events:
        name = e.name()
        start = e.start_ns()
        if _on_device(e):
            if not (name.startswith(PREFIX) or name.startswith(PROGRAM)):
                device.append((start, start + e.duration_ns()))
        elif name == PREFIX + "window":
            win = (start, start + e.duration_ns())
        elif name.startswith(PROGRAM):
            ranges.append((start, start + e.duration_ns(), name[len(PROGRAM):]))
        elif LAUNCH.match(name):
            launches.append(start)
    if win is None:
        return {}
    w0, w1 = win
    _, merged = _union([(max(a, w0), min(b, w1)) for a, b in device if b > w0 and a < w1])
    holes, prev = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > prev:
            holes.append((prev, a))
        prev = max(prev, b)
    idle = defaultdict(float)
    for (a, b), label in zip(holes, innermost(ranges, [(a + b) // 2 for a, b in holes])):
        idle[label or OUTSIDE] += (b - a) / 1e9
    launches = [t for t in launches if w0 <= t <= w1]
    by_span = defaultdict(int)
    for label in innermost(ranges, launches):
        by_span[label or OUTSIDE] += 1
    count = defaultdict(int)
    for a, _, name in ranges:
        if w0 <= a <= w1:
            count[name] += 1
    return {"idle_by_span": dict(idle), "launches_by_span": dict(by_span),
            "span_count": dict(count)}


def dispatch_launches(events, kept) -> list:
    """Each vocode dispatch whose range starts in the window, in order:
    {"launches", "rows", "cache_every", "join_ns"}, where `kept` is
    `profiling.spans()` and `join_ns` how far the kept span's start lies
    from its range's. A range with no kept span within JOIN_NS is left out."""
    win, ranges, launches = None, [], []
    for e in events:
        if _on_device(e):
            continue
        name, start = e.name(), e.start_ns()
        if name == PREFIX + "window":
            win = (start, start + e.duration_ns())
        elif name == PROGRAM + DISPATCH:
            ranges.append((start, start + e.duration_ns()))
        elif LAUNCH.match(name):
            launches.append(start)
    if win is None:
        return []
    starts = [(a, ids) for name, _, a, _, ids in kept if name == DISPATCH]
    out = []
    for a, b in sorted(ranges):
        if not (win[0] <= a <= win[1]) or not starts:
            continue
        at, ids = min(starts, key=lambda s: abs(s[0] - a))
        if abs(at - a) > JOIN_NS:
            continue
        out.append({"launches": sum(a <= t <= b for t in launches), "rows": ids.get("rows"),
                    "cache_every": ids.get("cache_every"), "join_ns": abs(at - a)})
    return out


def span_gaps(fields: dict) -> list:
    """The ten largest `idle_by_span` entries, as `breakdown` lists them."""
    idle = sorted(fields.get("idle_by_span", {}).items(), key=lambda kv: -kv[1])[:10]
    return [[k, v] for k, v in idle]


def work_idle_share(fields: dict):
    """The share of the device's idle seconds that fall under a span doing
    the work (the engine's block or refill, the vocode flush, or a span
    inside them), not in a root's own time or outside every span, in %."""
    idle = fields.get("idle_by_span", {})
    total = sum(idle.values())
    if not total:
        return None
    return 100.0 * sum(v for k, v in idle.items() if k not in ROOTS + (OUTSIDE,)) / total


def metrics(run) -> dict:
    """The per-layer numbers, each None where the run holds nothing to
    read. `run` holds `spans` and `span_counters` (their growth over the
    window's unprofiled part), `profiled_span_counters` (over its profiled
    part) and `trace` (`read`'s fields). A step is one `engine.forward`."""
    sp, c = run.spans, run.span_counters
    steps = sp.get("engine.forward", {}).get("calls")
    launches = run.trace.get("launches_by_span", {})
    forwards = run.trace.get("span_count", {}).get("engine.forward")
    rows = run.profiled_span_counters.get("vocode.rows")
    samples = c.get("vocode.audio_samples")

    def ms_a_step(*names):
        if not steps or not any(n in sp for n in names):
            return None
        return sum(sp[n]["ns"] for n in names if n in sp) / 1e6 / steps

    return {
        "engine_launches_per_step.backlog":
            sum(launches.get(n, 0) for n in ENGINE_BLOCK) / forwards if forwards else None,
        "engine_forward_ms.backlog": ms_a_step("engine.forward"),
        "engine_sample_ms.backlog": ms_a_step("engine.sample"),
        "engine_wait_ms.backlog": ms_a_step("engine.done_read", "engine.fetch"),
        "vocode_launches_per_row.backlog":
            sum(launches.get(n, 0) for n in VOCODE) / rows if rows else None,
        "vocode_s_per_audio_s.backlog":
            sp["server.vocode"]["ns"] / 1e9 / (samples / SR)
            if samples and "server.vocode" in sp else None,
    }
