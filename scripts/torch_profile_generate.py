"""Where the time of the PyTorch port's ChatterboxTTS.generate goes, on one
CUDA card, for the smoke run's model (chip_smoke.py: full ChatterboxConfig()
width, random bf16 weights, the same ~90-character text and voice).

    python3 scripts/torch_profile_generate.py [--steps 32] [--tokens 250] [--trace DIR]
                                              [--batch 8] [--parts t3,s3gen,s3gen_batch]

After a warm-up request it profiles (torch.profiler, CPU + CUDA) each part
on its own, so that each trace stays small:
  t3           T3 generation of `--steps` tokens (prefill + decode loop);
  s3gen        S3Gen of `--tokens` speech tokens (the smoke request's length);
  s3gen_batch  the S3Gen tail of generate_batch: `--batch` rows of `--tokens`
               tokens in one dispatch (the conformer through K2, the CFM
               estimator through K3). Its wall time is taken twice with the
               profiler off first, and the share of the two masked-attention
               kernels in the device time is printed.
For each it prints the wall time, the device-busy share (summed kernel time
over wall time) and the top kernels by device time and operators by host
self time. --trace writes each part's Chrome trace into DIR.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def _report(name, prof, wall, top):
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_s = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"[{name}] wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
          f"busy={100 * busy_s / wall:.1f}% launches={sum(e.count for e in kernels)}")
    print(f"[{name}] top {top} kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms x{e.count:6d}  {e.key[:100]}")
    print(f"[{name}] top {top} operators by host self time:")
    for e in sorted(events, key=lambda e: -e.self_cpu_time_total)[:top]:
        print(f"  {e.self_cpu_time_total / 1e3:9.2f} ms x{e.count:6d}  {e.key[:100]}")
    return kernels, busy_s


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32, help="T3 tokens to profile")
    ap.add_argument("--tokens", type=int, default=250, help="S3Gen tokens to profile")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None, help="directory for Chrome traces")
    ap.add_argument("--batch", type=int, default=8, help="rows of the batched S3Gen dispatch")
    ap.add_argument("--parts", default="t3,s3gen", help="comma list of t3, s3gen, s3gen_batch")
    args = ap.parse_args()
    parts = set(args.parts.split(","))

    card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    from chatterbox_embed_tpu_torch.config import ChatterboxConfig
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    cfg = ChatterboxConfig()
    tts = ChatterboxTTS.from_random(seed=0, config=cfg, dtype=torch.bfloat16, device="cuda")
    tts.conds = chip_smoke._random_conds(cfg, "cuda")
    sample = dict(temperature=0.7, cfg_weight=0.5, repetition_penalty=1.2, min_p=0.05,
                  top_p=1.0, seed=0, draws=None)
    tts.generate(chip_smoke.TEXT, max_new_tokens=args.tokens, cfg_weight=0.5,
                 temperature=0.7, seed=0)                 # warm-up
    torch.cuda.synchronize()
    print(f"card: {card}")

    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
    if "t3" in parts:
        info: dict = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            tts._run_t3(chip_smoke.TEXT, tts.conds, max_new_tokens=args.steps, info=info,
                        **sample)
            wall = time.time() - t0
        print(f"[t3] steps={info['decode_steps']} ms_per_step_incl_prefill="
              f"{1e3 * wall / info['decode_steps']:.3f} (profiler on)")
        _report("t3", prof, wall, args.top)
        if args.trace:
            prof.export_chrome_trace(str(Path(args.trace) / "t3_trace.json"))

    rng = np.random.default_rng(0)
    if "s3gen" in parts:
        tokens = rng.integers(0, 6561, args.tokens)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            tts._run_s3gen(tokens, tts.conds.gen, seed=0)
            wall = time.time() - t0
        _report("s3gen", prof, wall, args.top)
        if args.trace:
            prof.export_chrome_trace(str(Path(args.trace) / "s3gen_trace.json"))

    if "s3gen_batch" in parts:
        rows = [rng.integers(0, 6561, args.tokens) for _ in range(args.batch)]
        for run in ("warmup", "off_1", "off_2"):          # wall times, profiler off
            t0 = time.time()
            _, _, vinfo = tts._vocode_batch(rows, conds=tts.conds, seed=0)
            print(f"[s3gen_batch] run={run} rows={args.batch} tokens={args.tokens} "
                  f"wall_s={time.time() - t0:.4f} {vinfo}")
        counts = chip_smoke._counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            tts._vocode_batch(rows, conds=tts.conds, seed=0)
            wall = time.time() - t0
        kernels, busy_s = _report("s3gen_batch", prof, wall, args.top)
        after = chip_smoke._counts()
        att_s = sum(e.self_device_time_total for e in kernels
                    if "masked_attention" in e.key) / 1e6
        print(f"[s3gen_batch] masked_attention_device_s={att_s:.4f} "
              f"share_of_device_time={100 * att_s / busy_s:.1f}% launches="
              f"{ {k: after[k] - counts[k] for k in ('rel_attention', 'flash_attention')} } "
              f"card={card!r}")
        if args.trace:
            prof.export_chrome_trace(str(Path(args.trace) / "s3gen_batch_trace.json"))


if __name__ == "__main__":
    main()
