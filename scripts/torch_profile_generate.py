"""Where the time of the PyTorch port's ChatterboxTTS.generate goes, on one
CUDA card, for the smoke run's model (chip_smoke.py: full ChatterboxConfig()
width, random bf16 weights, the same ~90-character text and voice).

    python3 scripts/torch_profile_generate.py [--steps 32] [--tokens 250] [--trace DIR]
                                              [--batch 8] [--k4-rows 2,4,8,16]
                                              [--parts k1,k4,steps,t3,s3gen,s3gen_batch]

It runs each part on its own (after a warm-up request, unless it runs
only k1 and k4):
  k1           K1 and K1s alone (bf16, B 2 and 16, Lc 512 and 1280) and the
               K6 probe, device time from torch.profiler (probes/timing.py);
  k4           the fused step (K4) alone, profiler off: the model's weights
               in bf16 on a random Lc-512 cache, `--k4-rows` rows, 50 steps
               enqueued behind a spin kernel (so the card never waits on the
               host), CUDA events over the 50 (probes/timing.fused_step_ms):
               2 rows at each of pos 44, 260 and 507, other row counts at 507;
  steps        the wall time of the decode step, profiler off: generate of
               `--tokens` tokens twice on the route the environment selects
               (CHATTERBOX_FUSED_STEP=1: the fused step, K4), then once on
               the default step (K1); t3_s and ms a step of each;
and profiles (torch.profiler, CPU + CUDA) the others, so that each trace
stays small:
  t3           T3 generation of `--steps` tokens (prefill + decode loop),
               with the fused step's share of the device time;
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
import os
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


def k1_times(card) -> None:
    """K1 and K1s (bf16, the smoke's shapes: 16 heads of 64, start 4, pos
    three quarters into the cache, a dead range in some rows) and the K6
    probe, by probes/timing.device_ms."""
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    from chatterbox_embed_tpu_torch.probes import decode_anatomy as pda
    from chatterbox_embed_tpu_torch.probes import timing
    g = torch.Generator(device="cuda").manual_seed(5)
    h, d = 16, 64
    for b in (2, 16):
        for lc in (512, 1280):
            q = torch.randn((b, h, d), generator=g, device="cuda").to(torch.bfloat16)
            k, v = (torch.randn((lc, b, h, d), generator=g, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            u = b // 2
            lo = [70 + 3 * r for r in range(u)]
            hole = torch.tensor([[lo[r], lo[r] + (0 if r % 3 == 0 else 4 * r + 5)]
                                 for r in range(u)] * 2, dtype=torch.int32, device="cuda")
            start, pos = 4, min(lc - 1, 4 + (lc - 4) * 3 // 4)
            k1 = timing.device_ms(lambda: fd.decode_attention(q, k, v, pos, start, hole), 50)
            k1s = timing.device_ms(lambda: fd.decode_attention(
                q, k[None], v[None], pos, start, hole, layer=0, k_cur=q, v_cur=q), 50)
            print(f"[k1] b={b} lc={lc} start={start} pos={pos} k1_device_ms={k1:.5f} "
                  f"k1s_device_ms={k1s:.5f} card={card!r}")
    res = pda.run(steps=(1024,), device_iters=30)
    for mode, key in pda.SCRIPT_KEY.items():
        for _, tag in pda.POSITIONS:
            print(f"[k6] mode={mode} at={tag} device_us={res[f'{key}_{tag}_device_us']:.3f} "
                  f"cold_device_us={res[f'{key}_{tag}_cold_device_us']:.3f} card={card!r}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=32, help="T3 tokens to profile")
    ap.add_argument("--tokens", type=int, default=250, help="S3Gen tokens to profile")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--trace", default=None, help="directory for Chrome traces")
    ap.add_argument("--batch", type=int, default=8, help="rows of the batched S3Gen dispatch")
    ap.add_argument("--parts", default="t3,s3gen",
                    help="comma list of k1, k4, steps, t3, s3gen, s3gen_batch")
    ap.add_argument("--k4-rows", default="2", help="comma list of K4's row counts to time")
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
    if parts - {"k1", "k4"}:
        tts.generate(chip_smoke.TEXT, max_new_tokens=args.tokens, cfg_weight=0.5,
                     temperature=0.7, seed=0)             # warm-up
    torch.cuda.synchronize()
    print(f"card: {card}")

    if args.trace:
        Path(args.trace).mkdir(parents=True, exist_ok=True)
    if "k1" in parts:
        k1_times(card)
    if "k4" in parts:
        from chatterbox_embed_tpu_torch.kernels import fused_decode
        from chatterbox_embed_tpu_torch.probes import timing
        lcfg = cfg.t3.llama
        fused = fused_decode.stack_for_fused(tts.t3_params["llama"], lcfg, torch.bfloat16)
        lc, start = 512, 4
        for b in (int(r) for r in args.k4_rows.split(",")):
            positions = (44, 260, 507) if b == 2 else (507,)
            for pos, ms in timing.fused_step_ms(fused, lcfg, b, positions, lc, start).items():
                print(f"[k4] b={b} lc={lc} start={start} pos={pos} queued_ms={ms:.5f} "
                      f"card={card!r}")
        del fused
        torch.cuda.empty_cache()

    if "steps" in parts:
        fused_env = os.environ.get("CHATTERBOX_FUSED_STEP", "0")
        for route, env in (("env", fused_env), ("env", fused_env), ("default", "0")):
            os.environ["CHATTERBOX_FUSED_STEP"] = env
            tts.generate(chip_smoke.TEXT, max_new_tokens=args.tokens, cfg_weight=0.5,
                         temperature=0.7, seed=0)
            perf = tts.perf
            print(f"[steps] route={route} CHATTERBOX_FUSED_STEP={env} "
                  f"use_fused={perf['use_fused']} decode_steps={perf['decode_steps']} "
                  f"t3_s={perf['t3_s']:.4f} "
                  f"ms_per_step={1e3 * perf['t3_s'] / perf['decode_steps']:.3f} card={card!r}")
        os.environ["CHATTERBOX_FUSED_STEP"] = fused_env

    if "t3" in parts:
        info: dict = {}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            tts._run_t3(chip_smoke.TEXT, tts.conds, max_new_tokens=args.steps, info=info,
                        **sample)
            wall = time.time() - t0
        print(f"[t3] steps={info['decode_steps']} ms_per_step_incl_prefill="
              f"{1e3 * wall / info['decode_steps']:.3f} (profiler on)")
        kernels, busy_s = _report("t3", prof, wall, args.top)
        fused_s = sum(e.self_device_time_total for e in kernels
                      if "fused_step_kernel" in e.key) / 1e6
        print(f"[t3] fused_step_device_s={fused_s:.4f} "
              f"share_of_device_time={100 * fused_s / busy_s:.1f}% card={card!r}")
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
