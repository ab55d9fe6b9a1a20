"""The DeepSeek-V2 engine's decode step on one CUDA card, under the
tts-dsv2-backlog cell's weights, traffic and geometry, measured three ways
in turns within one process:

- `plain`: the engine without the routing record;
- `record`: with the routing record, as every benchmark run serves;
- `counted`: with the record and the MoE device counters captured into the
  step's graph, as a `--trace 1` run serves.

Each engine takes three blocks in each of three rounds, the three engines
in turn; the engine's own clock (`t_decode / steps_run`) gives ms a step.
Then one prefill's time (six requests, each alone, synchronised), and one
block of the `plain` engine under torch.profiler: device microseconds a
step, the kernels by device time (K7 is `moe_kernel`), and the peak of
allocated memory. Prints one line per reading and a last JSON line.

    python3 scripts/dsv2_step_probe.py [--seed N] [--rounds 3] [--blocks 3]

The weights are drawn from the seed as the benchmark draws them
(portbench/lib/model_dsv2.py), about 31 GB in bf16 on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chatterbox_embed_tpu_torch.models import t3_engine  # noqa: E402
from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer  # noqa: E402
from chatterbox_embed_tpu_torch.utils import profiling  # noqa: E402
from chatterbox_embed_tpu_torch.weights import place  # noqa: E402
from portbench.lib import model, model_dsv2, traffic  # noqa: E402

CELL = "tts-dsv2-backlog"


def _requests(cfg, cell, pc, dev, seed: int, n: int):
    conds = [model.port_conds(v, dev) for v in model.voices(cfg, 4, seed)]
    tok = FallbackTokenizer(pc.t3)
    tr = cell["traffic"]
    out = []
    for k in range(n):
        r = traffic.request(tr, seed, k)
        text = tok.text_to_tokens(r.text)[0]
        tt = np.concatenate([[pc.t3.start_text_token], text, [pc.t3.stop_text_token]])
        out.append((tt.astype(np.int32)[None], conds[r.voice].t3, r.seed, r.tokens))
    return out


def _engine(params, pc, cell, reqs, dev, record: bool, counted: bool):
    """A decoder with its queue, its first block run (the warm-up and the
    capture): the device counters are on during the capture when
    `counted`, so that the graph holds them."""
    sv = cell["server"]
    profiling.reset()
    profiling.enable_device_counters(counted)
    try:
        dec = t3_engine.ContinuousDecoder(
            params, pc.t3, slots=sv["slots"], text_bucket=sv["text_bucket"],
            max_new_tokens=sv["max_new_tokens"], block=sv["block"], dtype=torch.bfloat16,
            device=dev, route_record=record)
        for tt, cond, seed, cap in reqs:
            dec.submit(tt, cond, seed=seed, max_new_tokens=cap, **cell["traffic"]["sampling"])
        dec.step()
    finally:
        profiling.enable_device_counters(False)
    return dec


def _blocks(dec, n: int) -> float:
    t, s = dec.t_decode, dec.steps_run
    for _ in range(n):
        dec.step()
        dec.routes.clear()
    return 1e3 * (dec.t_decode - t) / (dec.steps_run - s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2718281829)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=3)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = json.loads((ROOT / "portbench" / "workloads" / f"{CELL}.json").read_text())
    cfg = model.load_config(cell["config"])
    pc = model_dsv2.port_config(cfg)
    t0 = time.time()
    params = place(model_dsv2.make_t3(cfg, args.seed, dev), dev, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"weights {time.time() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB",
          flush=True)
    reqs = _requests(cfg, cell, pc, dev, args.seed, 160)
    modes = {"plain": (False, False), "record": (True, False), "counted": (True, True)}
    engines = {name: _engine(params, pc, cell, reqs, dev, *flags)
               for name, flags in modes.items()}
    ms = {name: [] for name in modes}
    for rnd in range(args.rounds):
        for name, dec in engines.items():
            ms[name].append(_blocks(dec, args.blocks))
            print(f"round {rnd} {name}: {ms[name][-1]:.3f} ms a step", flush=True)
    counters = profiling.totals()["counters"]
    print("device counters of the counted engine:",
          {k: v for k, v in counters.items() if k.startswith("moe.")}, flush=True)

    prefill_ms = []
    p_len = engines["plain"].p_len
    for tt, cond, _, _ in reqs[:6]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t3_engine.prefill_request(params, cond, tt, text_bucket=cell["server"]["text_bucket"],
                                  p_len=p_len, cfg=pc.t3, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
    print("prefill ms", [round(x, 2) for x in prefill_ms], flush=True)

    from torch.profiler import ProfilerActivity, profile
    dec = engines["plain"]
    with profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU]) as prof:
        s = dec.steps_run
        dec.step()
        torch.cuda.synchronize()
    n = max(dec.steps_run - s, 1)
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total_us = sum(e.self_device_time_total for e in events) / n
    print(f"profiled block: {n} steps, device {total_us:.1f} us a step", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"{e.self_device_time_total / n:10.1f} us a step {e.count / n:8.1f} calls a step  "
              f"{e.key[:100]}", flush=True)
    k7_us = sum(e.self_device_time_total for e in events if "moe_kernel" in e.key) / n
    out = {"card": torch.cuda.get_device_name(dev),
           "ms_a_step": {k: [round(x, 4) for x in v] for k, v in ms.items()},
           "ms_a_step_median": {k: float(np.median(v)) for k, v in ms.items()},
           "prefill_ms": [round(x, 3) for x in prefill_ms],
           "profiled_device_us_a_step": round(total_us, 1), "k7_us_a_step": round(k7_us, 1),
           "memory_peak_gb": round(torch.cuda.max_memory_allocated(dev) / 1e9, 3)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
