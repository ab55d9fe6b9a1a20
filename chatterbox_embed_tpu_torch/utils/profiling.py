"""Observability: per-stage wall timers and optional torch.profiler traces,
the PyTorch counterpart of `chatterbox_embed_tpu/utils/profiling.py`.

A thin layer: `StageTimers` sums host seconds by stage (the JAX package's
class, copied); `trace` records a torch.profiler trace when a directory is
given or CHATTERBOX_PROFILE_DIR is set, and does nothing otherwise;
`annotate` names a region inside a trace. Device times of kernels are
measured with `probes/timing.py`, not here.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)


class StageTimers:
    """Accumulates per-stage wall time; exposes the reference-style
    audio_duration/generation_time ratio."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": round(v, 4), "count": self.counts[k],
                    "mean_s": round(v / max(self.counts[k], 1), 4)}
                for k, v in sorted(self.totals.items())}

    def log(self, prefix: str = "perf"):
        for k, s in self.summary().items():
            logger.info("%s | %s: %.3fs over %d calls", prefix, k,
                        s["total_s"], s["count"])


@contextlib.contextmanager
def trace(name: str = "chatterbox", log_dir: Optional[str] = None) -> Iterator[None]:
    """torch.profiler trace of the block, gated by `log_dir` or
    CHATTERBOX_PROFILE_DIR: the host's activity, and the card's when one is
    present, written as a Chrome trace `<name>-<pid>-<ns>.pt.trace.json` in
    that directory (open it in Perfetto or chrome://tracing)."""
    log_dir = log_dir or os.getenv("CHATTERBOX_PROFILE_DIR")
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with annotate(name):
            yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"{name}-{os.getpid()}-{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """Named region inside a trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
