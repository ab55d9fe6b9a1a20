"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, one or more lines each, then the result line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 switched off for matmuls and convolutions.
  2. build: compiles every kernel of the main path from the sources in the
     checkout (nvcc, sm_90a) and prints the build seconds.
  3. kernel check: each kernel against its plain PyTorch version on the
     card, at the main path's shapes, with the stated error limits; both
     versions' device time per call (torch.profiler) and per-call time of
     back-to-back calls (CUDA events).
  4. generate: ChatterboxTTS.generate at the full ChatterboxConfig() width
     with random bf16 weights, twice (warm-up, then timed); checks the wav
     and that every decode step went through the kernel.
  5. a JSON line describing each kernel, then the last line
     {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero with no result line. It
needs CUDA: without a card it fails at once.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# main-path shapes of the flash-decode kernel: the CFG pair (B=2) of the
# 16x64-head T3 Llama; cache capacity 512 at the smoke's 96-token text bucket
# and 250 new tokens, 1280 at the default max_new_tokens=1000
KERNEL_B, KERNEL_H, KERNEL_D = 2, 16, 64
KERNEL_LC = (512, 1280)
# fp32: kernel and plain version differ only in summation order over a few
# hundred unit-variance terms; 1e-5 is ~100x the fp32 rounding of outputs
# of size ~0.1. bf16: both round the fp32 result to bf16 once, so they may
# differ by one bf16 step of the output (2^-7 relative, <= 0.0156 for
# |out| < 4); 2e-2 covers that.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
TEXT = ("The quick brown fox jumps over the lazy dog while the band plays "
        "a slow song by the river.")


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()), flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return out[0]


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_line()
    print(card, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        matmul_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_tf32=torch.backends.cudnn.allow_tf32)
    return card


def phase_build() -> None:
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    t0 = time.time()
    path = fd.build()
    fd._library()
    log("build", kernel="flash_decode", seconds=f"{time.time() - t0:.2f}",
        library=path.relative_to(fd._PKG.parent))


def _time_ms(fn, iters: int = 200) -> float:
    """Per-call time of back-to-back calls from CUDA events: what a caller's
    loop pays, host enqueue included when the host is the slower side."""
    for _ in range(10):
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


def _device_ms(fn, iters: int = 50) -> float:
    """Device time per call: the summed kernel time that torch.profiler
    records for `iters` calls (host enqueue excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return us / 1e3 / iters


def phase_kernel_check(card: str) -> dict:
    """flash_decode kernel vs decode_attention_reference on the card."""
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    g = torch.Generator(device="cuda").manual_seed(1234)
    b, h, d = KERNEL_B, KERNEL_H, KERNEL_D
    worst = 0.0
    timing = {}
    for lc in KERNEL_LC:
        # (start, cache_pos) pairs: inside one split, across split edges,
        # a start on an edge, the last slot, and the smoke's decode range
        cases = [(0, 0), (3, 40), (10, 63), (63, 64), (64, 300), (130, 381),
                 (5, lc - 1)]
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
            k = torch.randn((lc, b, h, d), generator=g, device="cuda").to(dtype)
            v = torch.randn((lc, b, h, d), generator=g, device="cuda").to(dtype)
            holes = [None, torch.tensor([[0, 0], [70, 200]], dtype=torch.int32,
                                        device="cuda")]
            for hole in holes:
                for start, pos in cases:
                    out = fd.decode_attention(q, k, v, pos, start, hole)
                    ref = fd.decode_attention_reference(q, k, v, pos, start, hole)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    if not np.isfinite(err) or err > TOL[dtype]:
                        raise AssertionError(
                            f"flash_decode Lc={lc} {dtype} start={start} pos={pos} "
                            f"hole={hole is not None}: max|err|={err} > {TOL[dtype]}")
                    worst = max(worst, err) if dtype == torch.bfloat16 else worst
                    log("kernel", name="flash_decode", lc=lc, dtype=str(dtype)[6:],
                        start=start, pos=pos, hole=hole is not None,
                        max_abs_err=f"{err:.3e}", limit=TOL[dtype])
            if dtype == torch.bfloat16:
                # time at the decode step's shape: the live range the main
                # path reaches mid-generation
                start, pos = 4, min(lc - 1, 4 + (lc - 4) * 3 // 4)
                def kernel():
                    return fd.decode_attention(q, k, v, pos, start)

                def plain():
                    return fd.decode_attention_reference(q, k, v, pos, start)
                t = {"ms": _device_ms(kernel), "plain_ms": _device_ms(plain),
                     "call_ms": _time_ms(kernel), "plain_call_ms": _time_ms(plain)}
                timing[lc] = t
                log("kernel_time", name="flash_decode", lc=lc, dtype="bfloat16",
                    start=start, pos=pos, device_ms=f"{t['ms']:.5f}",
                    plain_device_ms=f"{t['plain_ms']:.5f}",
                    call_ms=f"{t['call_ms']:.5f}",
                    plain_call_ms=f"{t['plain_call_ms']:.5f}", card=repr(card))
    return {"max_abs_err": worst, "timing": timing}


def _random_conds(cfg, device):
    """Conditionals shaped like a prepared 10 s voice: speaker embedding,
    150 prompt speech tokens, 300 prompt mel frames, x-vector."""
    from chatterbox_embed_tpu_torch.conditionals import Conditionals
    from chatterbox_embed_tpu_torch.models.t3 import T3Cond
    rng = np.random.default_rng(0)
    n_prompt = cfg.t3.speech_cond_prompt_len
    t3c = T3Cond(
        speaker_emb=torch.tensor(rng.standard_normal((1, cfg.t3.speaker_embed_size)),
                                 dtype=torch.float32),
        cond_prompt_speech_tokens=torch.tensor(rng.integers(0, 6561, (1, n_prompt)),
                                               dtype=torch.int32),
        emotion_adv=0.5)
    gen = dict(prompt_token=rng.integers(0, 6561, (1, n_prompt)).astype(np.int64),
               prompt_token_len=np.array([n_prompt], np.int64),
               prompt_feat=rng.standard_normal((1, 2 * n_prompt, cfg.s3gen.mel_num)
                                               ).astype(np.float32),
               prompt_feat_len=None,
               embedding=rng.standard_normal((1, cfg.s3gen.flow.spk_embed_dim)
                                             ).astype(np.float32))
    return Conditionals(t3c, gen).to(device)


# fp32 teacher-forcing check of the decode path at full width: after the
# final RMSNorm the hidden state has unit RMS; kernel-path decode and the
# plain causal forward differ only by fp32 summation order through 30
# layers, so 1e-3 leaves ~10^4 fp32 epsilons of room.
DECODE_TOL = 1e-3


def phase_decode_consistency(tts) -> float:
    """T3's Llama at full width in fp32: prefill a context, run decode steps
    (each attends through the flash-decode kernel against the in-place
    cache), and compare every step's hidden state with one plain causal
    forward over the same sequence (written-out attention, no cache)."""
    from chatterbox_embed_tpu_torch.models import llama
    from chatterbox_embed_tpu_torch.weights import place
    cfg = tts.cfg.t3.llama
    params = place(tts.t3_params["llama"], "cuda", torch.float32)
    g = torch.Generator(device="cuda").manual_seed(7)
    b, p_len, steps, pad = 2, 132, 8, 4
    x = torch.randn((b, p_len + steps, cfg.hidden_size), generator=g, device="cuda")
    pos = (torch.arange(p_len + steps, device="cuda") - pad).clamp_min(0)[None].expand(b, -1)
    total = 512
    with torch.no_grad():
        idx = torch.arange(p_len, device="cuda")
        kidx = torch.arange(total, device="cuda")
        mask = ((kidx[None] <= idx[:, None]) & (kidx[None] >= pad))[None]
        cache = llama.init_cache(cfg, b, total, torch.float32, "cuda")
        _, cache = llama.forward(params, x[:, :p_len], pos[:, :p_len], mask, cache,
                                 0, cfg, torch.float32)
        dec = []
        for i in range(steps):
            hh, cache = llama.forward(params, x[:, p_len + i:p_len + i + 1],
                                      pos[:, p_len + i:p_len + i + 1], cache=cache,
                                      cache_pos=p_len + i, cfg=cfg, dtype=torch.float32,
                                      flash_start=pad)
            dec.append(hh)
        t = p_len + steps
        full_mask = ((torch.arange(t, device="cuda")[None] <= torch.arange(t, device="cuda")[:, None])
                     & (torch.arange(t, device="cuda")[None] >= pad))[None]
        ref, _ = llama.forward(params, x, pos, full_mask, cfg=cfg, dtype=torch.float32)
    torch.cuda.synchronize()
    err = (torch.cat(dec, dim=1) - ref[:, p_len:]).abs().max().item()
    if not np.isfinite(err) or err > DECODE_TOL:
        raise AssertionError(f"decode through the kernel vs plain forward: "
                             f"max|err|={err} > {DECODE_TOL}")
    log("decode_check", layers=cfg.num_layers, width=cfg.hidden_size, steps=steps,
        dtype="float32", max_abs_err=f"{err:.3e}", limit=DECODE_TOL)
    return err


def phase_generate(card: str):
    from chatterbox_embed_tpu_torch.config import ChatterboxConfig
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    cfg = ChatterboxConfig()
    t0 = time.time()
    tts = ChatterboxTTS.from_random(seed=0, config=cfg, dtype=torch.bfloat16,
                                    device="cuda")
    tts.conds = _random_conds(cfg, "cuda")
    torch.cuda.synchronize()
    log("model", config="ChatterboxConfig()", dtype="bfloat16",
        t3_layers=cfg.t3.llama.num_layers, d=cfg.t3.llama.hidden_size,
        init_s=f"{time.time() - t0:.2f}", text_chars=len(TEXT))
    phase_decode_consistency(tts)
    for run in ("warmup", "timed"):
        fd.decode_attention.launches = 0
        wav = tts.generate(TEXT, max_new_tokens=250, cfg_weight=0.5,
                           temperature=0.7, seed=0)
        launches = fd.decode_attention.launches
        perf = dict(tts.perf)
        n_tok = perf["speech_tokens"]
        steps = perf["decode_steps"]
        if wav.ndim != 2 or wav.shape[0] != 1 or wav.shape[1] != 2 * n_tok * 480:
            raise AssertionError(f"wav shape {wav.shape}, want (1, {2 * n_tok * 480})")
        if not np.isfinite(wav).all():
            raise AssertionError("wav has non-finite samples")
        if launches != cfg.t3.llama.num_layers * steps or steps == 0:
            raise AssertionError(f"flash_decode launched {launches} times for {steps} "
                                 f"decode steps x {cfg.t3.llama.num_layers} layers")
        log("generate", run=run, tokens=n_tok, decode_steps=steps,
            flash_decode_launches=launches, wav_samples=wav.shape[1],
            peak_abs=f"{float(np.abs(wav).max()):.4f}",
            t3_s=f"{perf['t3_s']:.4f}", s3gen_s=f"{perf['s3gen_s']:.4f}",
            tokens_per_s=f"{perf['tokens_per_s']:.2f}", rtf=f"{perf['rtf']:.4f}",
            card=repr(card))
    return launches


if __name__ == "__main__":
    card = phase_device()
    phase_build()
    check = phase_kernel_check(card)
    launches = phase_generate(card)
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    print(json.dumps({"kernels": [{
        "name": "flash_decode", "route": "cuda",
        "source": str(fd.SOURCE.relative_to(fd._PKG.parent)),
        "replaces": "chatterbox_embed_tpu/kernels/flash_decode.py:85",
        "launches": launches, "max_abs_err": check["max_abs_err"],
        **check["timing"][KERNEL_LC[0]]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
