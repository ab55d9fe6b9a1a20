"""The port's tracing layer (utils/profiling.py) on the CPU: spans and
counters off by default and free when off, their nesting, self time, ids
and counters when on, inside the tiny continuous server of
tests/test_torch_continuous.py's geometry (port only, random weights), and
their clock against torch.profiler's."""
import threading
from collections import deque

import numpy as np
import pytest
import torch

from chatterbox_embed_tpu_torch.serving.continuous import ContinuousServer
from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
from chatterbox_embed_tpu_torch.utils import profiling
from torch_dist import tiny_conds, tiny_pipeline_config

torch.set_num_threads(2)
GEO = dict(slots=2, text_bucket=32, max_new_tokens=24, block=8, vocode_batch=2)
TEXTS = ["Hello world.", "A second test utterance.", "Third one."]
ENGINE_CHILDREN = ("engine.done_read", "engine.sample", "engine.forward", "engine.fetch")


@pytest.fixture(autouse=True)
def clean():
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def tts():
    tts = ChatterboxTTS.from_random(seed=1, config=tiny_pipeline_config(), device="cpu")
    tts.conds = tiny_conds(tts.cfg)
    return tts


def _drain(tts):
    """The three requests through two slots (a refill mid-decode, two
    vocode flushes). Returns (wavs by rid, the server)."""
    srv = ContinuousServer(tts, **GEO)
    srv.decoder.retain_results = True            # the engine's tokens, for the counters
    for i, text in enumerate(TEXTS):
        srv.submit(text, seed=3 + i, cfg_weight=0.5, temperature=0.8)
    wavs = srv.drain()
    assert not srv.failed and len(wavs) == len(TEXTS)
    return wavs, srv


@pytest.fixture(scope="module")
def served(tts):
    """The same traffic with spans off, then on: the wavs of both, the
    server of the second, its totals and spans."""
    profiling.disable()
    profiling.reset()
    off, _ = _drain(tts)
    profiling.enable()
    try:
        on, srv = _drain(tts)
    finally:
        profiling.disable()
    return dict(off=off, on=on, srv=srv, totals=profiling.totals(), spans=profiling.spans())


class _Counting:
    """Stands in for a callable and counts its calls."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def test_off_is_one_shared_no_op(monkeypatch):
    clock = _Counting(profiling.time.perf_counter_ns)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", clock)
    first = profiling.span("engine.block")
    assert profiling.span("server.vocode", rids=[1, 2]) is first
    with first as entered:
        assert entered is None
    profiling.count("vocode.rows", 5)
    assert clock.calls == 0
    assert profiling.totals() == {"spans": {}, "counters": {}} and profiling.spans() == []


def test_a_served_drain_records_nothing_with_spans_off(tts, monkeypatch):
    ranges = _Counting(profiling.record_function)
    clock = _Counting(profiling.time.perf_counter_ns)
    made = _Counting(profiling._Span)
    monkeypatch.setattr(profiling, "record_function", ranges)
    monkeypatch.setattr(profiling.time, "perf_counter_ns", clock)
    monkeypatch.setattr(profiling, "_Span", made)
    _drain(tts)
    assert (ranges.calls, clock.calls, made.calls) == (0, 0, 0)
    assert profiling.totals() == {"spans": {}, "counters": {}} and profiling.spans() == []


def test_spans_leave_the_tokens_and_wavs_as_they_were(served):
    off, on = served["off"], served["on"]
    assert sorted(off) == sorted(on)
    for rid in off:
        np.testing.assert_array_equal(on[rid], off[rid])


def test_served_spans_nest_where_the_work_runs(served):
    parents = {}
    for name, parent, start, end, _ in served["spans"]:
        parents.setdefault(name, set()).add(parent)
        assert end >= start
    want = {"server.pump": {None}, "engine.step": {"server.pump"},
            "engine.refill": {"engine.step"}, "engine.prefill": {"engine.refill"},
            "engine.block": {"engine.step"}, "engine.noise": {"engine.sample"},
            "server.vocode": {"server.pump"}}
    want.update({c: {"engine.block"} for c in ENGINE_CHILDREN})
    want.update({s: {"server.vocode"} for s in ("s3gen.prepare", "s3gen.dispatch",
                                                "s3gen.fetch")})
    want.update({s: {"s3gen.dispatch"} for s in ("s3gen.encoder", "s3gen.cfm", "s3gen.hift")})
    assert parents == want


def test_served_counters_agree_with_the_server(served):
    srv, tot = served["srv"], served["totals"]
    sp, c = tot["spans"], tot["counters"]
    dec = srv.decoder
    assert sp["engine.forward"]["calls"] == dec.steps_run > 0
    assert sp["engine.sample"]["calls"] == sp["engine.noise"]["calls"] == dec.steps_run
    # one done read a step, and one more in each block that ended early
    assert dec.steps_run <= sp["engine.done_read"]["calls"] <= dec.steps_run + dec.blocks_run
    assert sp["engine.block"]["calls"] == dec.blocks_run
    assert sp["engine.prefill"]["calls"] == len(dec._results)
    wavs = served["on"]
    assert set(c) == {"vocode.rows", "vocode.audio_samples"}
    assert c["vocode.rows"] == len(wavs)
    assert c["vocode.audio_samples"] == sum(w.size for w in wavs.values())
    assert sp["server.vocode"]["calls"] == sp["s3gen.dispatch"]["calls"] == 2


def test_served_span_ids_name_the_requests(served):
    ids = {}
    for name, _, _, _, i in served["spans"]:
        ids.setdefault(name, []).append(i)
    rids = sorted(served["on"])
    assert sorted(i["rid"] for i in ids["engine.prefill"]) == rids
    assert sorted(r for i in ids["server.vocode"] for r in i["rids"]) == rids
    assert sorted(i["dispatch"] for i in ids["s3gen.fetch"]) == [0, 0]
    # each flush is one dispatch of its rows, at the exact solver
    assert ids["s3gen.dispatch"] == [dict(dispatch=0, rows=len(i["rids"]), cache_every=0)
                                     for i in ids["server.vocode"]]
    assert all(i == {} for i in ids["engine.block"])


def test_self_time_is_the_time_no_child_covers(monkeypatch):
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: next(ticks))
    profiling.enable()
    with profiling.span("outer", rid=7):          # 10 .. 80
        with profiling.span("inner"):             # 20 .. 30
            pass
        with profiling.span("inner"):             # 40 .. 70
            with profiling.span("leaf"):          # 50 .. 60
                pass
    sp = profiling.totals()["spans"]
    assert sp["outer"] == {"calls": 1, "ns": 70, "self_ns": 70 - 10 - 30}
    assert sp["inner"] == {"calls": 2, "ns": 40, "self_ns": 30}
    assert sp["leaf"] == {"calls": 1, "ns": 10, "self_ns": 10}
    kept = profiling.spans()
    off = kept[-1][2] - 10                          # the offset to the Unix clock
    assert [(n, p, a - off, b - off, i) for n, p, a, b, i in kept] == [
        ("inner", "outer", 20, 30, {}), ("leaf", "inner", 50, 60, {}),
        ("inner", "outer", 40, 70, {}), ("outer", None, 10, 80, {"rid": 7})]


def test_counters_reset_and_the_oldest_spans_drop(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", deque(maxlen=3))
    profiling.enable()
    for k in range(5):
        with profiling.span("s", k=k):
            profiling.count("n", 2)
    assert [i["k"] for *_, i in profiling.spans()] == [2, 3, 4]
    assert profiling.totals() == {"spans": {"s": profiling.totals()["spans"]["s"]},
                                  "counters": {"n": 10}}
    assert profiling.totals()["spans"]["s"]["calls"] == 5
    profiling.reset()
    assert profiling.totals() == {"spans": {}, "counters": {}} and profiling.spans() == []


def test_spans_nest_per_thread():
    profiling.enable()
    gate = threading.Barrier(2, timeout=10)

    def work(tag):
        with profiling.span(f"outer.{tag}"):
            gate.wait()
            with profiling.span(f"inner.{tag}"):
                gate.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    parents = {n: p for n, p, *_ in profiling.spans()}
    assert parents == {"inner.a": "outer.a", "inner.b": "outer.b", "outer.a": None,
                       "outer.b": None}


def test_a_span_lies_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("engine.block"):
                torch.ones(32, 32) @ torch.ones(32, 32)
    with profiling.span("outside"):
        pass
    events = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                    if e.name() == "chatterbox.engine.block")
    mine = [(a, b) for n, _, a, b, _ in profiling.spans() if n == "engine.block"]
    assert len(events) == len(mine) == 3
    for got, (start, end) in zip(events, mine):
        assert abs(start - got) < 1_000_000 and end > start
    assert [n for n, *_ in profiling.spans()][-1] == "outside"


def test_trace_carries_the_engines_spans_and_restores_off(tts, tmp_path):
    srv = ContinuousServer(tts, **GEO)
    srv.submit(TEXTS[0], seed=3)
    with profiling.trace("serve", log_dir=str(tmp_path)):
        srv.drain()
    files = list(tmp_path.iterdir())
    assert len(files) == 1
    text = files[0].read_text()
    assert '"chatterbox.engine.block"' in text and '"chatterbox.serve"' in text
    assert profiling.span("after") is profiling.span("again")     # off again
    assert profiling.totals()["spans"]["serve"]["calls"] == 1
