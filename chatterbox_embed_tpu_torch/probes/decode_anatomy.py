"""Decode-anatomy probe: the flash-decode walk's time on the card, split
into its loads and its attention math.

    python -m chatterbox_embed_tpu_torch.probes.decode_anatomy

The counterpart of `scripts/microbench_decode_anatomy.py`'s main(): the three
variants of `kernels/decode_anatomy.py:attn` (full; load_only, under the
script's key `dma_only`; compute_only) at pos 44 (one 64-slot chunk) and 379
(six), on the script's shape: 16 rows x 16 heads x 64, a 1024-slot bf16
cache. One line per measurement on stderr and one JSON object on stdout with
the script's keys, `{mode}_{1chunk|6chunk}_s{steps}_us`: microseconds per
launch in a chain of `steps` back-to-back launches (CUDA events; the host's
enqueue counts where it is the slower side). Beside them, per variant,
torch.profiler's device time per launch with the cache warm in L2
(`..._device_us`) and with the L2 flushed before every launch
(`..._cold_device_us`, what the decode step sees, whose weights stream
through the cache between two attention calls), and the card's name and
power limit under "card". Without a CUDA card this raises.
"""
from __future__ import annotations

import json
import sys

import numpy as np
import torch

from ..kernels import decode_anatomy as da
from . import timing

B, H, D, TOTAL = 16, 16, 64, 1024
F = B * H * D
POSITIONS = ((44, "1chunk"), (379, "6chunk"))
STEPS = (1024, 4096)
SCRIPT_KEY = {"full": "full", "load_only": "dma_only", "compute_only": "compute_only"}
KERNEL_NAMES = ("anatomy_kernel",)


def run(steps=STEPS, device_iters: int = 50, seed: int = 0, out=sys.stderr) -> dict:
    """The sweep on the current CUDA device; returns the results dict."""
    timing.require_cuda()
    dev = torch.device("cuda", torch.cuda.current_device())
    card = timing.card_line()
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                ).to(dev).to(torch.bfloat16)
               for shape in ((1, F), (TOTAL, F), (TOTAL, F)))
    flush = timing.L2Flush(dev)
    results = {}
    for mode in da.MODES:
        for pos, tag in POSITIONS:
            name = f"{SCRIPT_KEY[mode]}_{tag}"

            def call():
                return da.attn(q, k, v, pos, mode)
            for n in steps:
                results[f"{name}_s{n}_us"] = 1e3 * timing.time_ms(call, n)
            results[f"{name}_device_us"] = 1e3 * timing.device_ms(
                call, device_iters, only=KERNEL_NAMES)
            results[f"{name}_cold_device_us"] = 1e3 * timing.device_ms(
                call, device_iters, before=flush, only=KERNEL_NAMES)
            print(f"[anat] {mode} {tag}: "
                  + "  ".join(f"steps{n} {results[f'{name}_s{n}_us']:.2f} us/launch"
                              for n in steps)
                  + f"  device {results[f'{name}_device_us']:.2f} us"
                  + f"  cold {results[f'{name}_cold_device_us']:.2f} us  card={card!r}",
                  file=out, flush=True)
    results["card"] = card
    return results


def main():
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
