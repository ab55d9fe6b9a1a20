"""The port's one CUDA-graph capture (`Graphed`): a step cut into pieces,
each a callable over static buffers that returns its outputs.

- Off the card `step` runs the step, which calls each piece through `run`.
- On the card the first step is the warm-up, the whole step eager on the
  device's one capture stream: it builds the kernels, library plans and
  device constants, and its own outputs are what it returns (a capture
  runs nothing: the graphs' outputs hold values from the first replay on).
  Then each piece is captured in order into one memory pool, inside
  `flash_decode.graph_workspaces()`, and later steps replay the graphs
  through `run`, never two at once.
- A capture records launches without running them: each counter of the
  kernel table (kernels.table) is read around a piece's capture, the
  capture's count taken back (`launches`: a piece's {kernel: launches a
  replay}) and added again at each replay, as the eager step would count.

A capture that fails raises; nothing falls back to the eager step. The
card is reached through the module's `cuda` alone (a test fakes it).
"""
from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch
from torch import cuda

from .. import kernels
from ..kernels import flash_decode
from . import profiling

_STREAMS: dict = {}


@contextlib.contextmanager
def _on_capture_stream(device):
    """The block on the device's capture stream, ordered after the current
    stream's work and before what the current stream does next."""
    side = _STREAMS.get(str(device))
    if side is None:
        side = _STREAMS[str(device)] = cuda.Stream(device)
    main = cuda.current_stream(device)
    side.wait_stream(main)
    with cuda.stream(side):
        yield
    main.wait_stream(side)


class Graphed:
    """A step's pieces: `out[k]` holds piece k's last outputs, which later
    pieces may read. After the capture: `graphs` (one a piece),
    `launches`, `pool_bytes` (what the capture reserved), `workspaces`
    (the kernels' own, kept with the graphs) and `replays` (steps
    replayed). `span` names a profiling span around the capture."""

    def __init__(self, pieces: Sequence[Callable[[], object]], device,
                 span: Optional[str] = None):
        self.pieces = list(pieces)
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.span = span
        self.out: List[object] = [None] * len(self.pieces)
        self.graphs: Optional[list] = None
        self.launches: List[dict] = [{} for _ in self.pieces]
        self.workspaces: dict = {}
        self.pool_bytes = self.replays = 0

    @property
    def captured(self) -> bool:
        return self.graphs is not None

    def run(self, k: int):
        """Piece k, called or replayed: its outputs."""
        if self.graphs is None:
            self.out[k] = self.pieces[k]()
        else:
            self.graphs[k].replay()
            kernels.add_launches(self.launches[k])
        return self.out[k]

    def _all(self):
        return [self.run(k) for k in range(len(self.pieces))][-1]

    def step(self, fn: Optional[Callable[[], object]] = None):
        """One step, `fn` (default: every piece in order, giving the last
        one's outputs), and its result; on the card the first is the
        warm-up, followed by the capture."""
        fn = fn or self._all
        if self.graphs is not None:
            self.replays += 1
        if self.graphs is not None or not self.on_card:
            return fn()
        with _on_capture_stream(self.device):
            result = fn()
        self.capture()
        return result

    def capture(self) -> None:
        """Record each piece in order as a CUDA graph in one memory pool."""
        with profiling.span(self.span) if self.span else contextlib.nullcontext():
            cuda.synchronize(self.device)
            cuda.empty_cache()
            reserved = cuda.memory_reserved(self.device)
            pool, graphs = cuda.graph_pool_handle(), []
            with flash_decode.graph_workspaces() as own, _on_capture_stream(self.device):
                for k, piece in enumerate(self.pieces):
                    graph = cuda.CUDAGraph()
                    before = kernels.launches()
                    graph.capture_begin(pool=pool)
                    try:
                        self.out[k] = piece()
                    finally:
                        graph.capture_end()
                        ran = {n: c - before[n] for n, c in kernels.launches().items()
                               if c != before[n]}
                        kernels.add_launches({n: -c for n, c in ran.items()})
                    self.launches[k] = ran
                    graphs.append(graph)
            self.graphs, self.workspaces = graphs, own
            self.pool_bytes = cuda.memory_reserved(self.device) - reserved
