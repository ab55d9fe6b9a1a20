"""Weight-stream probe: what a hand-written stream of the T3 decode step's
weights reaches on the card, by slab size and ring depth.

    python -m chatterbox_embed_tpu_torch.probes.weight_stream

The counterpart of `scripts/microbench_weight_stream.py`'s main(): the same
sweep (slab 1 / 2 / 4 MB, nbuf 2 / 4, a bf16 wall of 1 GB, about the bf16
backbone, then an int8 wall of half the bytes) through the kernel
`kernels/weight_stream.py:stream_once`, one line per configuration on
stderr and one JSON object with the script's keys on stdout
({"bf16_slab1MB_nbuf2": {"ms_per_pass": ..., "GBps": ...}, ...}), plus the
card's name and power limit under "card".

Timing is the card's: torch.profiler's device time of the kernel over
back-to-back launches ("ms_per_pass", "GBps") and CUDA events over the same
loop ("call_ms"). The wall is far larger than the L2 cache, so every pass
reads it from device memory. Without a CUDA card this raises.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..kernels import weight_stream as ws
from . import timing

TOTAL_MB = 1024                # about the 1.06 GB bf16 backbone
BF16_SWEEP = ((1, 2), (1, 4), (2, 2), (2, 4), (4, 2), (4, 4))     # (slab MB, nbuf)
INT8_SWEEP = ((1, 2), (1, 4), (2, 2))


def run(total_mb: int = TOTAL_MB, iters: int = 20, seed: int = 0, out=sys.stderr) -> dict:
    """The sweep on the current CUDA device; returns the results dict."""
    timing.require_cuda()
    dev = torch.device("cuda", torch.cuda.current_device())
    card = timing.card_line()
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((ws.ROWS_X, ws.D)).astype(np.float32)
                         ).to(dev).to(torch.bfloat16)
    results = {}
    for dtype, tag, sweep in ((torch.bfloat16, "bf16", BF16_SWEEP),
                              (torch.int8, "int8", INT8_SWEEP)):
        itemsize = 2 if tag == "bf16" else 1
        total_bytes = (total_mb << 20) if tag == "bf16" else (total_mb << 19)
        flat = ws.make_wall(1, total_bytes // (ws.D * itemsize), dtype, dev)
        for slab_mb, nbuf in sweep:
            rows = (slab_mb << 20) // (ws.D * itemsize)
            w = flat.reshape(total_bytes // (slab_mb << 20), rows, ws.D)    # a view
            ms = timing.device_ms(lambda: ws.stream_once(x, w, nbuf), iters)
            call_ms = timing.time_ms(lambda: ws.stream_once(x, w, nbuf), iters, warmup=2)
            key = f"{tag}_slab{slab_mb}MB_nbuf{nbuf}"
            results[key] = {"ms_per_pass": ms, "GBps": total_bytes / (ms / 1e3) / 1e9,
                            "call_ms": call_ms}
            print(f"[wstream] {key}: {ms:.4f} ms/pass  {results[key]['GBps']:.0f} GB/s  "
                  f"(events {call_ms:.4f} ms)  card={card!r}", file=out, flush=True)
        del flat, w
        torch.cuda.empty_cache()
    results["card"] = card
    results["total_mb"] = total_mb
    return results


def main():
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
