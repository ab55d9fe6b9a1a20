"""Timing on the card, the way the port measures everywhere: CUDA events
over back-to-back launches, and torch.profiler's device time per kernel.
Both need a CUDA device and raise without one."""
from __future__ import annotations

import math
import subprocess

import torch


def require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: torch.cuda.is_available() is False; "
                           "the port's probes measure the card and run nowhere else")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Per-call time of back-to-back calls from CUDA events: what a caller's
    loop pays, host enqueue included when the host is the slower side."""
    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


SPIN_CYCLES = 100_000_000      # torch.cuda._sleep: ~50 ms of one spinning thread


def queued_ms(fn, iters: int = 50, warmup: int = 20) -> float:
    """Device time per call of a kernel that is long beside its launch (the
    fused step): `iters` calls enqueued behind a spin kernel, so that the
    card never waits on the host, timed by CUDA events around the calls."""
    require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def fused_step_ms(fused, cfg, b: int, positions, lc: int = 512, start: int = 4,
                  seed: int = 0, iters: int = 50) -> dict:
    """The fused T3 step (K4) in bf16 at each of `positions`: b rows of
    `fused` (kernels/fused_decode.stack_for_fused) on random activations and
    a random Lc-`lc` cache, `queued_ms` over `iters` steps. pos -> ms."""
    from chatterbox_embed_tpu_torch.kernels import fused_decode
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, cfg.hidden_size), generator=g, device="cuda").to(torch.bfloat16)
    ck, cv = (torch.randn((cfg.num_layers, lc, b, cfg.num_heads, cfg.head_dim), generator=g,
                          device="cuda").to(torch.bfloat16) for _ in range(2))
    return {pos: queued_ms(lambda: fused_decode.fused_decode_step(
        fused, x, ck, cv, pos, start, cfg, torch.bfloat16), iters) for pos in positions}


def device_ms(fn, iters: int = 50, tries: int = 3, before=None, only=None) -> float:
    """Device time per call: the kernel time that torch.profiler records
    for `iters` calls (host enqueue excluded). `before` runs ahead of every
    call (an L2 flush, say); `only` keeps the kernels whose name contains
    one of these strings (so that `before`'s kernels do not count). A
    capture on an H100 can lose kernel records: all of them about once in
    ten runs (the capture is taken again, up to `tries` captures), or a few,
    often the first, so that dividing the recorded time by `iters` read a
    kernel up to 2x short. So each kernel counts as its mean recorded
    duration times the whole number of launches a call it makes
    (ceil(count / iters): exact while fewer than `iters` records of it are
    lost)."""
    require_cuda()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total / e.count * math.ceil(e.count / iters)
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count
                 and (only is None or any(s in e.key for s in only)))
        if us > 0:
            return us / 1e3
    raise RuntimeError(f"torch.profiler recorded no device time in {tries} captures")


class L2Flush:
    """Overwrites a buffer larger than the card's L2 (50 MB on an H100), so
    that the next kernel finds its inputs in device memory, as a caller does
    whose other kernels stream through the cache in between."""

    def __init__(self, device, mbytes: int = 256):
        self.buf = torch.empty(mbytes << 20, dtype=torch.uint8, device=device)

    def __call__(self):
        self.buf.zero_()
