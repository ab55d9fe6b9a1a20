"""The port's one CUDA-graph capture (chatterbox_embed_tpu_torch/utils/
graphs.py) on the CPU, with a fake card in the module's `cuda`: its graphs
record nothing and count their replays. A step's first run on the card is
the warm-up, whose own outputs come back, then the capture of every piece
in order into one pool; a kernel launch counted while a piece is captured
is taken back and added again at each of its replays; off the card the
pieces are called as they are."""
import contextlib
from types import SimpleNamespace

import torch

from chatterbox_embed_tpu_torch import kernels
from chatterbox_embed_tpu_torch.kernels import layer_norm, moe_experts
from chatterbox_embed_tpu_torch.utils import graphs


class _Stream:
    def wait_stream(self, other):
        pass


def _fake_card(log):
    """A stand-in for torch.cuda: a graph logs its capture's pool and its
    replays; memory grows 64 bytes a capture."""
    reserved = [1000]

    class Graph:
        def capture_begin(self, pool=None):
            log.append(("begin", pool))
            reserved[0] += 64

        def capture_end(self):
            log.append(("end",))

        def replay(self):
            log.append(("replay", self))

    return SimpleNamespace(
        Stream=lambda device: _Stream(), current_stream=lambda device: _Stream(),
        stream=lambda s: contextlib.nullcontext(), synchronize=lambda device=None: None,
        empty_cache=lambda: None, memory_reserved=lambda device=None: reserved[0],
        graph_pool_handle=lambda: "pool", CUDAGraph=Graph)


def _pieces(calls, device):
    """A Graphed of two pieces on `device`: the first launches K8 twice,
    the second K7 once on the first's output. Each call returns new
    outputs."""
    def first():
        layer_norm.layer_norm.launches += 2
        calls.append("first")
        return {"n": len(calls)}

    def second():
        moe_experts.grouped_swiglu.launches += 1
        calls.append("second")
        return {"n": len(calls), "after": graph.out[0]["n"]}

    graph = graphs.Graphed([first, second], device)
    return graph


def test_a_capture_counts_nothing_and_each_replay_its_launches(monkeypatch):
    log, calls = [], []
    monkeypatch.setattr(graphs, "cuda", _fake_card(log))
    graph = _pieces(calls, torch.device("cuda"))
    assert graph.on_card and not graph.captured
    before = kernels.launches()

    def grown():
        now = kernels.launches()
        return {n: now[n] - before[n] for n in now if now[n] != before[n]}

    warm = graph.step()                      # the warm-up, then the capture
    assert warm == {"n": 2, "after": 1}      # the warm-up's own outputs
    assert calls == ["first", "second"] * 2 and graph.captured
    assert graph.out == [{"n": 3}, {"n": 4, "after": 3}]
    assert [e[:2] for e in log] == [("begin", "pool"), ("end",)] * 2
    assert graph.launches == [{"layer_norm": 2}, {"moe_experts": 1}]
    assert graph.pool_bytes == 128 and graph.replays == 0
    assert grown() == {"layer_norm": 2, "moe_experts": 1}   # the warm-up's alone

    log.clear()
    for k in (1, 2, 3):
        assert graph.step() is graph.out[1]
        assert grown() == {"layer_norm": 2 * (k + 1), "moe_experts": k + 1}
    assert len(calls) == 4 and graph.replays == 3
    assert [e[1] for e in log] == graph.graphs * 3
    kernels.add_launches({n: -c for n, c in grown().items()})


def test_off_the_card_the_pieces_are_called(monkeypatch):
    log, calls = [], []
    monkeypatch.setattr(graphs, "cuda", _fake_card(log))
    graph = _pieces(calls, "cpu")
    before = kernels.launches()
    for k in (1, 2):
        assert graph.step() == {"n": 2 * k, "after": 2 * k - 1}
    assert not graph.captured and not log and graph.replays == 0
    now = kernels.launches()
    assert {n: now[n] - before[n] for n in now if now[n] != before[n]} == {
        "layer_norm": 4, "moe_experts": 2}
    kernels.add_launches({"layer_norm": -4, "moe_experts": -2})
