"""Voice conversion one job at a time (`vc.ChatterboxVC.generate`): the
worker's VC mode. One client sends the next source when the last wav is
back; each source is seeded speech-like 16 kHz audio (a gliding harmonic
series under a syllable-rate envelope, plus noise), converted into one of
the voices made in set-up. A request is due when it is sent.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from ..lib import check, model, stats, traffic, work
from ..lib.trace import Patches

SR_IN = 16_000
SR = 24_000
WARM = 1 << 40          # request indices of the warm-up, past any window's


def speech_like(seed: int, k: int, tokens: int) -> np.ndarray:
    """`tokens` / 25 seconds of 16 kHz audio, a whole number of 40 ms tokens."""
    rng = np.random.default_rng([int(seed), int(k), 5])
    n = tokens * (SR_IN // 25)
    t = np.arange(n) / SR_IN
    f0 = 110.0 + 60.0 * rng.uniform() + 30.0 * np.sin(2 * np.pi * rng.uniform(0.2, 0.6) * t)
    phase = 2 * np.pi * np.cumsum(f0) / SR_IN
    voiced = sum(np.sin(h * phase) / h for h in range(1, 9))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3.0, 5.0) * t) ** 2
    x = 0.3 * env * voiced + 0.01 * rng.standard_normal(n)
    return (0.9 * x / np.abs(x).max()).astype(np.float32)


def run(ctx) -> dict:
    cfg, cell, dev = ctx.cfg, ctx.cell, ctx.device
    tr = cell["traffic"]
    from chatterbox_embed_tpu_torch.vc import ChatterboxVC

    pc = model.port_config(cfg)
    w = model.make_weights(cfg, ("flow", "hift", "tokenizer"), ctx.seed, dev)
    vc = ChatterboxVC(w["s3gen"], config=pc, dtype=model.DTYPES[cfg["dtype"]], device=dev)
    del w
    voices = model.voices(cfg, tr["voices"], ctx.seed)
    factory = model.DrawFactory(model.source(cfg, ctx.seed, dev), dev)
    ctx.reset_peak()

    served = {}          # the last conversion's tokens, mel and wav (before the watermark)
    to_wav = vc._tokens_to_wav
    mels = model.MelKeeper()

    def kept(tokens, seed=0, draws=None):
        wav = to_wav(tokens, seed, draws)
        served.update(ids=np.asarray(tokens), wav=wav, mel=mels.take()[0])
        return wav

    vc._tokens_to_wav = kept

    def convert(r, src):
        vc.ref_dict = voices[r.voice]["gen"]
        return vc.generate(src, seed=r.seed, draws=factory(r.seed))

    # warm-up: one source of each length the traffic draws (every block of
    # requests takes the same lengths)
    sizes = sorted({traffic.request(tr, ctx.seed, k).tokens for k in range(traffic.BLOCK)})
    for j, n in enumerate(sizes):
        convert(traffic.request(tr, ctx.seed, WARM + j), speech_like(ctx.seed, WARM + j, n))

    patches = Patches()
    if ctx.trace:
        from chatterbox_embed_tpu_torch.models import s3tokenizer
        patches.wrap(vc, "_tokens_to_wav", "tokens_to_wav")
        patches.wrap(s3tokenizer, "tokenize_wave", "tokenize", time_it=False)
    total = {"audio_s": 0.0, "model_flops": 0.0}
    t0 = ctx.open_window(patches, lambda: dict(total))
    t_end = t0 + ctx.seconds
    rows, lat, k = [], [], 0
    while True:
        r = traffic.request(tr, ctx.seed, k)
        src = speech_like(ctx.seed, k, r.tokens)
        k += 1
        due = time.perf_counter()
        if due >= t_end:
            break
        convert(r, src)
        t = time.perf_counter()
        lat.append(t - due)                 # the last one may come back after the window
        if t > t_end:
            break
        rows.append((t, r, src, served["ids"], served["wav"], served["mel"]))
        total["audio_s"] += served["wav"].size / SR
        total["model_flops"] += (
            work.s3tokenizer_flops(cfg["s3gen"]["tokenizer"], len(served["ids"]))
            + work.s3gen_flops(cfg["s3gen"], cfg["voice"]["s3gen_prompt_tokens"],
                               len(served["ids"])))
        ctx.tick()
    ctx.close_window(patches)
    result = dict(
        attempted=len(lat), failed=0,
        e2e={"audio_s_per_s": stats.rate([(x[0], x[4].size / SR) for x in rows], t0, t_end),
             "request_p90_s": stats.percentile(lat, 90)},
        layer=ctx.layer_inputs(dict(total), patches),
        log=[f"completed {len(rows)} of {len(lat)} requests due, {total['audio_s']:.3f} s of "
             f"audio; latency median {stats.percentile(lat, 50):.4f} s"])
    patches.remove()
    ctx.read_memory()

    rng = np.random.default_rng([ctx.seed, 99])
    order = sorted(rows, key=lambda x: (-x[1].tokens, x[1].k))
    pick = order[:1]
    if len(order) > 1:
        idx = rng.choice(len(order) - 1, size=min(cell["check"]["rows"] - 1, len(order) - 1),
                         replace=False)
        pick += [order[1 + i] for i in sorted(idx)]
    judge_rows = [(x[2], x[1].voice, x[3], x[4], x[5]) for x in pick]
    mels.remove()
    del vc, factory, rows, order
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    result["numbers"] = ctx.judge(lambda prec: check.vc_checks(cfg, ctx.seed, voices, judge_rows,
                                                               dev, prec))
    result["log"].append(f"reference: {len(judge_rows)} conversions of "
                         f"{[x[1].tokens for x in pick]} tokens, "
                         f"{time.perf_counter() - t_ref:.1f} s")
    return result
