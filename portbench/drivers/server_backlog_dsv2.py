"""tts-backlog's closed backlog through `serving.continuous.ContinuousServer`
on T3 with the DeepSeek-V2 backbone (`lib/model_dsv2.py`): the same
traffic, server geometry and vocode flushes, and the engine's step one CUDA
graph with the latent cache and K7.

As `server_backlog.py`, with these differences:
- the weights are drawn leaf by leaf (`model_dsv2`);
- the engine keeps its routing record, and each request's expert ids are
  kept for the check when its wav comes back in the window; the check is
  `lib/check_dsv2.py`;
- with --trace 1 the port's device counters are on from before the warm-up
  (its spans stay off), so that the engine's graph captures the MoE
  layers' counters (`moe.*`); their growth over the profiled part goes to
  the metrics as `profiled.moe.*`; the wrappers are server_backlog's but
  K1's, which this backbone never calls (the vocode flush, the engine's
  block and refill, K3's calls with their key masks);
- a request that the server decodes again (fewer than its minimum of
  speech tokens, `serving.continuous.MIN_TOKENS`) is served from the
  retry's draws, whose seed is not the request's: the engine's seed of
  each decode is kept (a wrapper of the decoder's `submit` and `step`), and
  the check replays the draws of the decode that was served;
- the profiled part ends after a flush, or at twice `profile_seconds`: the
  profiler slows the graphed step's ~1,300 kernels and takes seconds to
  stop, and the window's unprofiled part, where the step is timed, has to
  outlast both.
"""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from ..lib import check, check_dsv2, model, model_dsv2, stats, traffic, work, work_dsv2
from ..lib.trace import Patches
from .server_backlog import _k3_record, _pick

SR = 24_000
MOE = ("moe.calls", "moe.assignments", "moe.experts_touched", "moe.max_expert_rows")


def run(ctx) -> dict:
    cfg, cell, dev = ctx.cfg, ctx.cell, ctx.device
    sv, tr = cell["server"], cell["traffic"]
    from chatterbox_embed_tpu_torch.models import layers
    from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer
    from chatterbox_embed_tpu_torch.serving.continuous import ContinuousServer
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    from chatterbox_embed_tpu_torch.utils import profiling

    pc = model_dsv2.port_config(cfg)
    w = model_dsv2.make_weights(cfg, ctx.seed, dev)
    tts = ChatterboxTTS(w["t3"], w["s3gen"], FallbackTokenizer(pc.t3), config=pc,
                        dtype=model.DTYPES[cfg["dtype"]], device=dev)
    del w
    voices = model.voices(cfg, tr["voices"], ctx.seed)
    conds = [model.port_conds(v, dev) for v in voices]
    factory = model.DrawFactory(model.source(cfg, ctx.seed, dev), dev)
    if ctx.trace:
        profiling.reset()
        profiling.enable_device_counters()
    srv = ContinuousServer(tts, slots=sv["slots"], text_bucket=sv["text_bucket"],
                           max_new_tokens=sv["max_new_tokens"], block=sv["block"],
                           vocode_batch=sv["vocode_batch"], retain_wavs=False,
                           make_draws=factory, route_record=True)
    ctx.reset_peak()

    dec = srv.decoder
    engine_seed = {}         # engine rid -> the seed its draws come from
    served_seed = {}         # external rid -> the seed of the decode it was served from
    submit_engine, step_engine = dec.submit, dec.step

    def seeded_submit(*args, **kw):
        rid = submit_engine(*args, **kw)
        engine_seed[rid] = int(kw.get("seed", 0))
        return rid

    def seeded_step(*args, **kw):
        done = step_engine(*args, **kw)
        for rid in done:
            served_seed[srv._ext_of.get(rid, rid)] = engine_seed.pop(rid)
        return done

    dec.submit, dec.step = seeded_submit, seeded_step

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
    routes = {}              # rid -> the window's requests' expert ids
    seeds = {}               # rid -> the window's requests' served seeds
    total = {"audio_s": 0.0, "model_flops": 0.0}
    again = 0                # requests served from a second decode
    window = [math.inf, math.inf]

    def pump():
        nonlocal again
        out = srv.pump()
        t = time.perf_counter()
        for rid, wav in out.items():
            finished[rid] = (t, wav)
            ids_kept = srv.routes.pop(rid, None)
            seed_kept = served_seed.pop(rid)
            again += seed_kept != reqs[rid].seed
            if window[0] <= t <= window[1]:
                r, (ids, _, _) = reqs[rid], flushes[id(wav)]
                routes[rid] = ids_kept
                seeds[rid] = seed_kept
                total["audio_s"] += wav.size / SR
                ctx_len = cfg["t3"]["perceiver_num_queries"] + 2 + len(r.text) + 2 + 2
                total["model_flops"] += (
                    work_dsv2.t3_flops(cfg["t3"], ctx_len, len(ids))
                    + work.s3gen_flops(cfg["s3gen"], cfg["voice"]["s3gen_prompt_tokens"],
                                       len(check.clean(ids, cfg))))
        for rid, why in srv.take_failures().items():
            failed.setdefault(rid, (t, why))
            served_seed.pop(rid, None)

    while len(finished) < sv["slots"] * tr["turnover"]:
        top_up()
        pump()

    eng = dec
    patches = Patches()
    if ctx.trace:
        patches.wrap(tts, "_vocode_batch", "vocode")
        patches.wrap(eng, "step", "engine", time_it=False)
        patches.wrap(eng, "_refill", "refill", time_it=False)
        patches.wrap(layers, "flash_attention", "k3", time_it=False, record=_k3_record)

    def snapshot():
        out = dict(total, t_decode_s=eng.t_decode, steps=eng.steps_run)
        if ctx.trace:
            counters = profiling.totals()["counters"]
            out.update((k_, counters.get(k_, 0)) for k_ in MOE)
        return out

    at_open = snapshot()
    t0 = ctx.open_window(patches, snapshot)
    window[:] = [t0, t0 + ctx.seconds]
    while True:
        top_up()
        pump()
        ctx.tick(ready=patches.calls["vocode"] > 0 or not ctx.trace
                 or time.perf_counter() >= t0 + 2 * cell["profile_seconds"])
        if time.perf_counter() >= window[1]:
            break
    ctx.close_window(patches)
    if ctx.trace:
        profiling.enable_device_counters(False)

    done = {rid: v for rid, v in finished.items() if t0 <= v[0] <= window[1]}
    bad = {rid: v for rid, v in failed.items() if t0 <= v[0] <= window[1]}
    layer = ctx.layer_inputs(snapshot(), patches)
    if ctx.trace:
        layer["counters"].update((f"profiled.{k_}", ctx.mark.counters[k_] - at_open[k_])
                                 for k_ in MOE)
    result = dict(
        attempted=len(done) + len(bad), failed=len(bad),
        e2e={"audio_s_per_s": stats.rate([(t, w.size / SR) for t, w in finished.values()],
                                         t0, window[1])},
        layer=layer,
        log=[f"completed {len(done)} requests in {len({v[0] for v in done.values()})} "
             f"flushes, {total['audio_s']:.3f} s of audio; "
             f"{eng.steps_run} engine steps in all; failed {len(bad)}; "
             f"{again} served from a second decode"])
    patches.remove()
    ctx.read_memory()

    rng = np.random.default_rng([ctx.seed, 99])
    ck = cell["check"]
    rows = []
    for rid, (t, wav) in done.items():
        ids, width, mel = flushes[id(wav)]
        rows.append((rid, reqs[rid], ids, width, wav, mel))
    rows.sort(key=lambda x: (-len(x[2]), x[0]))
    t3_pick = _pick(rows, ck["t3_rows"], rng)
    wav_pick = _pick(rows, ck["wav_rows"], rng)
    t3_rows = [(x[1].text, x[1].voice, x[2], tr["sampling"], seeds[x[0]], routes[x[0]])
               for x in t3_pick]
    wav_rows = [(x[2], x[1].voice, x[3], x[4], x[5]) for x in wav_pick]
    mels.remove()
    if ctx.trace:
        profiling.reset()
    del srv, tts, conds, eng, dec, factory, flushes, routes
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = ctx.judge(lambda prec: check_dsv2.tts_checks(cfg, ctx.seed, voices, t3_rows,
                                                           wav_rows, dev, prec))
    result["log"].append(f"reference: {len(t3_rows)} T3 rows of "
                         f"{[len(x[2]) for x in t3_pick]} tokens, {len(wav_rows)} wavs of "
                         f"{[len(x[2]) for x in wav_pick]} tokens, "
                         f"{time.perf_counter() - t_ref:.1f} s")
    result["numbers"] = numbers
    return result
