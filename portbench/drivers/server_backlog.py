"""Closed backlog through `serving.continuous.ContinuousServer`: the
Redis worker's story chunks with the engine kept full.

Requests are submitted so that at least `depth_per_slot - 1` times the
slots wait in the queue, each non-streamed; the server decodes them in
its slots and vocodes completions in batched flushes. The warm-up runs
the traffic until the slots have turned over `turnover` times, so that
completions are staggered when the window opens. A request's audio counts
when its wav comes back from `pump`.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from ..lib import check, model, stats, traffic, work
from ..lib.trace import Patches

SR = 24_000


def run(ctx) -> dict:
    cfg, cell, dev = ctx.cfg, ctx.cell, ctx.device
    sv, tr = cell["server"], cell["traffic"]
    from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer
    from chatterbox_embed_tpu_torch.serving.continuous import ContinuousServer
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS

    pc = model.port_config(cfg)
    w = model.make_weights(cfg, ("t3", "flow", "hift"), ctx.seed, dev)
    tts = ChatterboxTTS(w["t3"], w["s3gen"], FallbackTokenizer(pc.t3), config=pc,
                        dtype=model.DTYPES[cfg["dtype"]], device=dev)
    del w
    voices = model.voices(cfg, tr["voices"], ctx.seed)
    conds = [model.port_conds(v, dev) for v in voices]
    factory = model.DrawFactory(model.source(cfg, ctx.seed, dev), dev)
    srv = ContinuousServer(tts, slots=sv["slots"], text_bucket=sv["text_bucket"],
                           max_new_tokens=sv["max_new_tokens"], block=sv["block"],
                           vocode_batch=sv["vocode_batch"], retain_wavs=False,
                           make_draws=factory)
    ctx.reset_peak()

    # what each flush vocoded: the program's own tokens and mels, kept for
    # the check
    flushes = {}
    vocode = tts._vocode_batch
    mels = model.MelKeeper()

    def kept_vocode(token_lists, **kw):
        out = vocode(token_lists, **kw)
        width = check.bucket(max(len(check.clean(t, cfg)) for t in token_lists))
        for t, wav, mel in zip(token_lists, out[0], mels.take()):
            flushes[id(wav)] = (np.asarray(t), (width, len(token_lists)), mel)
        return out

    tts._vocode_batch = kept_vocode
    reqs = {}
    k = 0

    def top_up():
        nonlocal k
        while len(reqs) - len(finished) - len(failed) < sv["slots"] * tr["depth_per_slot"]:
            r = traffic.request(tr, ctx.seed, k)
            k += 1
            rid = srv.submit(r.text, conds[r.voice], seed=r.seed, max_new_tokens=r.tokens,
                             **tr["sampling"])
            reqs[rid] = r

    finished = {}            # rid -> (time handed back, wav)
    failed = {}
    total = {"audio_s": 0.0, "model_flops": 0.0}     # of the window's completions so far
    window = [math.inf, math.inf]

    def pump():
        out = srv.pump()
        t = time.perf_counter()
        for rid, wav in out.items():
            finished[rid] = (t, wav)
            if window[0] <= t <= window[1]:
                r, (ids, _, _) = reqs[rid], flushes[id(wav)]
                total["audio_s"] += wav.size / SR
                ctx_len = cfg["t3"]["perceiver_num_queries"] + 2 + len(r.text) + 2 + 2
                total["model_flops"] += (
                    work.t3_flops(cfg["t3"], ctx_len, len(ids))
                    + work.s3gen_flops(cfg["s3gen"], cfg["voice"]["s3gen_prompt_tokens"],
                                       len(check.clean(ids, cfg))))
        for rid, why in srv.take_failures().items():
            failed.setdefault(rid, (t, why))

    while len(finished) < sv["slots"] * tr["turnover"]:
        top_up()
        pump()

    eng = srv.decoder
    patches = Patches()
    if ctx.trace:
        _instrument(patches, tts, srv)
    snapshot = lambda: dict(total, t_decode_s=eng.t_decode, steps=eng.steps_run)
    t0 = ctx.open_window(patches, snapshot)
    window[:] = [t0, t0 + ctx.seconds]
    while True:
        top_up()
        pump()
        ctx.tick(ready=patches.calls["vocode"] > 0 or not ctx.trace)
        if time.perf_counter() >= window[1]:
            break
    ctx.close_window(patches)

    done = {rid: v for rid, v in finished.items() if t0 <= v[0] <= window[1]}
    bad = {rid: v for rid, v in failed.items() if t0 <= v[0] <= window[1]}
    result = dict(
        attempted=len(done) + len(bad), failed=len(bad),
        e2e={"audio_s_per_s": stats.rate([(t, w.size / SR) for t, w in finished.values()],
                                         t0, window[1])},
        layer=ctx.layer_inputs(snapshot(), patches),
        log=[f"completed {len(done)} requests in {len({v[0] for v in done.values()})} "
             f"flushes, {total['audio_s']:.3f} s of audio; "
             f"{eng.steps_run} engine steps in all; failed {len(bad)}"])
    patches.remove()
    ctx.read_memory()

    # the sample to judge, drawn from the seed: the longest request and
    # others, for T3 and for S3Gen
    rng = np.random.default_rng([ctx.seed, 99])
    ck = cell["check"]
    rows = []
    for rid, (t, wav) in done.items():
        ids, width, mel = flushes[id(wav)]
        rows.append((rid, reqs[rid], ids, width, wav, mel))
    rows.sort(key=lambda x: (-len(x[2]), x[0]))
    t3_pick = _pick(rows, ck["t3_rows"], rng)
    wav_pick = _pick(rows, ck["wav_rows"], rng)
    t3_rows = [(x[1].text, x[1].voice, x[2], tr["sampling"], x[1].seed) for x in t3_pick]
    wav_rows = [(x[2], x[1].voice, x[3], x[4], x[5]) for x in wav_pick]
    mels.remove()
    del srv, tts, conds, eng, factory, flushes
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = ctx.judge(lambda prec: check.tts_checks(cfg, ctx.seed, voices, t3_rows, wav_rows,
                                                      dev, prec))
    result["log"].append(f"reference: {len(t3_rows)} T3 rows of "
                         f"{[len(x[2]) for x in t3_pick]} tokens, {len(wav_rows)} wavs of "
                         f"{[len(x[2]) for x in wav_pick]} tokens, "
                         f"{time.perf_counter() - t_ref:.1f} s")
    result["numbers"] = numbers
    return result


def _pick(rows, n, rng):
    if not rows:
        return []
    rest = rows[1:]
    idx = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [rows[0]] + [rest[i] for i in sorted(idx)]


def _instrument(patches: Patches, tts, srv):
    """The traced run's wrappers: the vocode flush (its wavs are host
    arrays, so it has synchronised), the engine's block, K1's and K3's
    calls with their shapes."""
    from chatterbox_embed_tpu_torch.models import layers, llama
    patches.wrap(tts, "_vocode_batch", "vocode")
    patches.wrap(srv.decoder, "step", "engine", time_it=False)
    patches.wrap(srv.decoder, "_refill", "refill", time_it=False)
    patches.wrap(llama, "decode_attention", "k1", time_it=False, record=_k1_record)
    patches.wrap(layers, "flash_attention", "k3", time_it=False, record=_k3_record)


def _k1_record(q, k, v, cache_pos, start=0, hole=None, layer=None, k_cur=None, v_cur=None,
               span=None, k_scale=None, v_scale=None):
    return (tuple(q.shape), q.element_size(), int(cache_pos),
            start if not torch.is_tensor(start) else start, hole, span)


def _k3_record(q, k, v, key_valid):
    return (tuple(q.shape), q.element_size(), key_valid)
