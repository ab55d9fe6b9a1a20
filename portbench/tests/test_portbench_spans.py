"""The program's spans read from a trace (`lib/spans.py`) and the traced run
that turns them on (`span_run.py`), on the CPU: a synthetic trace with and
without the program's ranges and their mirrors on the device's timeline,
the vocode dispatches joined to the program's kept spans, the readings of
an empty run, and the tiny TTS cell; on a card, the cost of a span."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

import tiny
from portbench import run, span_run
from portbench.lib import spans, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    """The part of a profiler event that the readers use."""

    def __init__(self, name, start, end, device=CPU, corr=0):
        self._n, self._s, self._d, self._dev, self._c = name, start, end - start, device, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._c if self._dev == CUDA else 0


def _events(program: bool) -> list:
    """A window [0, 1000] ns with one benchmark range around an engine
    step; with `program`, the step's program ranges and their device-side
    mirrors. Kernels: two launched in engine.forward, a graph of three in
    engine.sample, a copy in engine.fetch, one kernel from the refill."""
    ev = [Event("portbench.window", 0, 1000), Event("portbench.engine", 50, 950),
          Event("cudaLaunchKernel", 60, 62, corr=1),          # in engine.prefill
          Event("cudaLaunchKernel", 210, 212, corr=2),        # in engine.forward
          Event("cuLaunchKernel", 220, 222, corr=3),          # in engine.forward
          Event("cudaGraphLaunch", 410, 415, corr=4),         # in engine.sample
          Event("cudaStreamSynchronize", 500, 700),           # waits, enqueues nothing
          Event("cudaMemcpyAsync", 720, 725, corr=5),         # in engine.fetch
          Event("kernel_a", 70, 150, CUDA, 1), Event("kernel_b", 230, 300, CUDA, 2),
          Event("kernel_c", 300, 380, CUDA, 3), Event("graph_k", 420, 440, CUDA, 4),
          Event("graph_k", 440, 460, CUDA, 4), Event("graph_k", 470, 480, CUDA, 4),
          Event("Memcpy DtoH", 730, 760, CUDA, 5)]
    if program:
        ranges = [("engine.step", 55, 900), ("engine.refill", 56, 190),
                  ("engine.prefill", 57, 180), ("engine.block", 195, 890),
                  ("engine.forward", 200, 400), ("engine.sample", 405, 700),
                  ("engine.fetch", 710, 880)]
        ev += [Event("chatterbox." + n, a, b) for n, a, b in ranges]
        ev += [Event("chatterbox." + n, a + 5, b, CUDA) for n, a, b in ranges]
    return ev


def test_existing_keys_read_as_before_with_program_ranges():
    plain = trace.read(_events(False))
    assert trace.read(spans.without_program_ranges(_events(True))) == plain
    # the device's busy time: the kernels and the copy alone, not the mirrors
    assert plain["busy_s"] == pytest.approx((80 + 150 + 50 + 30) / 1e9)
    assert plain["idle_by_range"] == {"host": pytest.approx(70 / 1e9),
                                      "engine": pytest.approx(620 / 1e9)}
    assert trace.read(_events(True))["busy_s"] > plain["busy_s"]


def test_program_ranges_label_gaps_and_launches():
    got = spans.read(_events(True))
    idle = {k: v * 1e9 for k, v in got["idle_by_span"].items()}
    # gaps: [0,70) host; [150,230) mid 190 refill; [380,420) mid 400
    # forward; [460,470) and [480,730) sample (mid 605); [760,1000) mid 880
    # fetch (a range holds its ends)
    assert idle == pytest.approx({"host": 70, "engine.refill": 80, "engine.forward": 40,
                                  "engine.sample": 10 + 250, "engine.fetch": 240})
    assert got["launches_by_span"] == {"engine.prefill": 1, "engine.forward": 2,
                                       "engine.sample": 1, "engine.fetch": 1}
    assert got["span_count"] == {n: 1 for n in ("engine.step", "engine.refill", "engine.prefill",
                                                "engine.block", "engine.forward",
                                                "engine.sample", "engine.fetch")}
    assert spans.span_gaps(got)[0] == ["engine.sample", pytest.approx(260 / 1e9)]
    assert spans.work_idle_share(got) == pytest.approx(100 * 620 / 690)


def test_dispatch_launches_join_the_kept_spans_by_start():
    ev = [Event("portbench.window", 0, 10_000_000),
          Event("chatterbox.s3gen.dispatch", 1_000, 2_000),
          Event("chatterbox.s3gen.dispatch", 3_000, 4_000),
          Event("chatterbox.s3gen.dispatch", 5_000_000, 6_000_000),     # nothing kept near
          Event("chatterbox.s3gen.dispatch", 3_500, 3_600, CUDA)]       # a mirror
    ev += [Event("cudaLaunchKernel", t, t + 1) for t in (1_100, 1_200, 2_500, 3_100)]
    ev += [Event("cudaGraphLaunch", 3_200, 3_201), Event("cudaStreamSynchronize", 3_300, 3_900)]
    ids = lambda rows: dict(dispatch=0, rows=rows, cache_every=2 if rows == 8 else 0)
    kept = [("s3gen.dispatch", "server.vocode", 900, 2_100, ids(8)),
            ("s3gen.hift", "s3gen.dispatch", 1_150, 1_900, {}),
            ("s3gen.dispatch", "server.vocode", 3_050, 4_100, ids(1))]
    assert spans.dispatch_launches(ev, kept) == [
        dict(launches=2, rows=8, cache_every=2, join_ns=100),
        dict(launches=2, rows=1, cache_every=0, join_ns=50)]
    assert spans.dispatch_launches(ev, []) == []
    assert spans.dispatch_launches(ev[1:], kept) == []                 # no window


def test_a_trace_without_program_ranges_labels_everything_outside():
    got = spans.read(_events(False))
    assert set(got["idle_by_span"]) == {"host"} and got["span_count"] == {}
    assert got["launches_by_span"] == {"host": 5}
    assert spans.read([e for e in _events(True) if e.name() != "portbench.window"]) == {}


def test_each_reading_is_none_where_the_run_holds_nothing():
    empty = SimpleNamespace(spans={}, span_counters={}, profiled_span_counters={}, trace={})
    assert set(spans.metrics(empty).values()) == {None}
    assert spans.work_idle_share({}) is None and spans.span_gaps({}) == []


def test_readings_by_hand():
    ns = lambda v: {"calls": 1, "ns": v, "self_ns": v}
    r = SimpleNamespace(
        spans={"engine.forward": dict(ns(30e6), calls=2), "engine.sample": ns(4e6),
               "engine.done_read": ns(2e6), "engine.fetch": ns(1e6), "server.vocode": ns(3e9)},
        span_counters={"vocode.audio_samples": 6 * 24_000},
        profiled_span_counters={"vocode.rows": 4},
        trace={"launches_by_span": {"engine.forward": 3000, "engine.sample": 100, "host": 7,
                                    "s3gen.cfm": 8000, "server.vocode": 40},
               "span_count": {"engine.forward": 2}})
    assert spans.metrics(r) == pytest.approx({
        "engine_launches_per_step.backlog": 1550.0, "engine_forward_ms.backlog": 15.0,
        "engine_sample_ms.backlog": 2.0, "engine_wait_ms.backlog": 1.5,
        "vocode_launches_per_row.backlog": 2010.0, "vocode_s_per_audio_s.backlog": 0.5})


@pytest.mark.parametrize("spans_on", [True, False], ids=["spans", "no_spans"])
def test_the_tiny_tts_cell_yields_the_program_span_readings(monkeypatch, spans_on):
    for obj, attr in ((trace, "read"), (run.Ctx, "open_window"), (run.Ctx, "_mark"),
                      (run.Ctx, "close_window")):
        monkeypatch.setattr(obj, attr, getattr(obj, attr))
    seen = span_run.instrument(run, spans_on)
    out, lines = run.run_cell("tts-backlog", 2 ** 31 + 77, 3.0, True, device="cpu",
                              cell=tiny.cell("tts-backlog"), cfg=tiny.config(),
                              manifest=tiny.manifest())
    assert out["correct"] is True, lines
    got = span_run.readings(seen)
    host = ("engine_forward_ms.backlog", "engine_sample_ms.backlog", "engine_wait_ms.backlog",
            "vocode_s_per_audio_s.backlog")
    device = ("engine_launches_per_step.backlog", "vocode_launches_per_row.backlog")
    if spans_on:
        assert all(got["metrics"][k] > 0 for k in host), got["metrics"]
        assert got["block_children_share"] > 50
    else:
        assert all(got["metrics"][k] is None for k in host)
        assert got["unprofiled"] == {"spans": {}, "counters": {}}
    # no profiler on the CPU: the device's readings find nothing
    assert all(got["metrics"][k] is None for k in device)
    from chatterbox_embed_tpu_torch.utils import profiling
    assert profiling.span("x") is profiling.span("y")           # off after the window


def _ns_a_call(fn, n: int) -> float:
    import time
    t = time.perf_counter_ns()
    for _ in range(n):
        fn()
    return (time.perf_counter_ns() - t) / n


@pytest.mark.card
def test_a_span_costs_little_on_the_cards_host(card):
    """ns a `with span(...)` and a `count` cost the host, less an empty
    loop's: off, on, and on while torch.profiler traces the card. Printed
    (run with -s), and held under bounds that keep a step's six spans
    under 2 % of a 37 ms step even while profiled."""
    from torch.profiler import ProfilerActivity, profile

    from chatterbox_embed_tpu_torch.utils import profiling

    def one_span():
        with profiling.span("engine.sample"):
            pass

    got = {}
    try:
        for _ in range(3):
            profiling.disable()
            profiling.reset()
            bare = _ns_a_call(lambda: None, 200_000)
            got.setdefault("off_span_ns", []).append(_ns_a_call(one_span, 200_000) - bare)
            got.setdefault("off_count_ns", []).append(
                _ns_a_call(lambda: profiling.count("vocode.rows"), 200_000) - bare)
            profiling.enable()
            got.setdefault("on_span_ns", []).append(_ns_a_call(one_span, 200_000) - bare)
            got.setdefault("on_count_ns", []).append(
                _ns_a_call(lambda: profiling.count("vocode.rows"), 200_000) - bare)
            profiling.reset()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                got.setdefault("profiled_span_ns", []).append(_ns_a_call(one_span, 20_000) - bare)
    finally:
        profiling.disable()
        profiling.reset()
    print(torch.cuda.get_device_name(card), {k: [round(v, 1) for v in vs] for k, vs in got.items()})
    assert max(got["off_span_ns"]) < 2_000 and max(got["off_count_ns"]) < 2_000
    assert max(got["on_span_ns"]) < 20_000 and max(got["on_count_ns"]) < 20_000
    assert max(got["profiled_span_ns"]) < 100_000
