"""Smoke run of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py

Phases, one or more lines each, then the result line:
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 switched off for matmuls and convolutions.
  2. build: compiles every kernel of the port from the sources in the
     checkout (nvcc, sm_90a), one nvcc process per source, all started
     together, and prints each build's seconds.
  3. kernel checks: each kernel against its plain PyTorch version on the
     card, in fp32 and bf16, at the shapes the main paths give it, with the
     stated error limits; both versions' device time per call
     (torch.profiler) and per-call time of back-to-back calls (CUDA events)
     at the main paths' shapes.
       K1 flash_decode     T3 decode attention: B=2 (one utterance) and B=16
                           (8 utterances, a different hole per row)
       K2 rel_attention    conformer rel-pos attention: B 4/8/16, T 406/812
                           and 2348, ragged masks with an all-valid row, a
                           single-valid-key row and a row with none
       K3 flash_attention  CFM estimator self-attention: B 8/16/32, T 812 and
                           2348, ragged masks with an all-valid row and a
                           single-valid-key row
  4. full-width fp32 consistency: decode through K1 against one plain causal
     forward; the conformer on 8 ragged rows (through K2) against each row
     alone (1 row, factored branch); the CFM estimator on 16 CFG rows
     (through K3) against each cond/uncond pair alone (2 rows, written-out
     attention).
  5. generate: ChatterboxTTS.generate at the full ChatterboxConfig() width
     with random bf16 weights, twice (warm-up, then timed); checks the wav
     and that every decode step went through K1.
  6. generate_batch: 8 texts in one lock-step batch, one voice, then two
     voices, each twice (warm-up, then timed); checks every wav and that
     the launch counts of K1, K2 and K3 are those of the path.
  7. a JSON line describing each kernel, then the last line
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

# main-path shapes of the flash-decode kernel: the CFG rows of the 16x64-head
# T3 Llama, B=2 for one utterance and B=16 for a batch of 8; cache capacity
# 512 at the smoke's 96-token text bucket and 250 new tokens, 1280 at the
# default max_new_tokens=1000
KERNEL_B, KERNEL_H, KERNEL_D = 2, 16, 64
KERNEL_B_BATCH = 16
KERNEL_LC = (512, 1280)
# fp32: kernel and plain version differ only in summation order over a few
# hundred unit-variance terms; 1e-5 is ~100x the fp32 rounding of outputs
# of size ~0.1. bf16: both round the fp32 result to bf16 once, so they may
# differ by one bf16 step of the output (2^-7 relative, <= 0.0156 for
# |out| < 4); 2e-2 covers that.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# K2 and K3 (8 heads of 64): unit-variance q and k give scaled logits of std
# ~3 over 576 terms (K2) and ~1 over 64 (K3); fp32 sums in another order
# differ at ~1e-6, so 1e-4 leaves ~100x room. bf16: one output step, as for
# K1 (the plain versions also round p to bf16 for p.v, ~2^-9 relative).
# The sharp K2 softmax puts outputs near single values of v, some above 4,
# where a bf16 step is 2^-5; so in bf16 the error is divided by
# max(1, |ref|) before it is held to 2e-2 (2^-7 = 0.0078 relative per step).
ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATT_H, ATT_D, REL_DA = 8, 64, 576
REL_SHAPES = [(b, t) for b in (4, 8, 16) for t in (406, 812)] + [(8, 2348)]
REL_TIMED = ((8, 812), (8, 406))
FLASH_SHAPES = [(b, t) for b in (8, 16, 32) for t in (812, 2348)]
FLASH_TIMED = ((16, 812),)
# fp32 batch against solo at full width: the outputs are unit-scale
# (after the conformer's final LayerNorm; the estimator's velocity); the
# two runs differ in summation order only (kernel against factored or
# written-out attention) through 10 conformer blocks or 56 transformer
# blocks, so 1e-3 leaves ~10^3 fp32 epsilons of room.
BATCH_TOL = 1e-3
TEXT = ("The quick brown fox jumps over the lazy dog while the band plays "
        "a slow song by the river.")
# generate_batch: 8 texts of 40-90 characters (42-92 tokens with SOT/EOT,
# all in the 96-token bucket), so the K1 holes are ragged
TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "She sells sea shells by the sea shore every summer.",
    "A slow song plays while the band packs up for the night.",
    "Rain fell on the old tin roof as the children slept soundly.",
    "The river bends twice before it meets the sea at the harbour.",
    "He wrote a letter to his brother and walked it to the post office.",
    "Every morning the baker opens the shop before the first bus arrives.",
    "The quick brown fox jumps over the lazy dog while the band plays a song.",
]
TEMPERATURES = [0.6, 0.63, 0.66, 0.69, 0.71, 0.74, 0.77, 0.8]
BATCH_KW = dict(max_new_tokens=250, cfg_weight=0.5, seed=0, temperature=TEMPERATURES)
BATCH_SUB = 8          # expected utterances per S3Gen dispatch
BATCH_STRIDE = 2       # expected CFM DeepCache stride at 8 live rows


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


def _kernels() -> dict:
    """name -> (kernel module, its counted wrapper, its C entry)."""
    from chatterbox_embed_tpu_torch.kernels import flash_attention as fa
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    from chatterbox_embed_tpu_torch.kernels import rel_attention as ra
    return {"flash_decode": (fd, fd.decode_attention, "cbx_flash_decode"),
            "rel_attention": (ra, ra.rel_attention, "cbx_rel_attention"),
            "flash_attention": (fa, fa.flash_attention, "cbx_flash_attention")}


def phase_build() -> None:
    from chatterbox_embed_tpu_torch.kernels import _build
    kernels = _kernels()
    built = _build.build_all([m.SOURCE for m, _, _ in kernels.values()])
    for name, (m, _, entry) in kernels.items():
        path, seconds = built[m.SOURCE]
        _build.load(m.SOURCE, entry, m._ARGTYPES)    # a bad library fails here
        log("build", kernel=name, seconds=f"{seconds:.2f}",
            library=path.relative_to(_build.PKG.parent))


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


def _timing(kernel, plain, iters: int = 50) -> dict:
    return {"ms": _device_ms(kernel, iters), "plain_ms": _device_ms(plain, iters),
            "call_ms": _time_ms(kernel, 4 * iters), "plain_call_ms": _time_ms(plain, 4 * iters)}


def _log_time(name: str, timing: dict, card: str, **shape) -> None:
    log("kernel_time", name=name, **shape, dtype="bfloat16",
        device_ms=f"{timing['ms']:.5f}", plain_device_ms=f"{timing['plain_ms']:.5f}",
        call_ms=f"{timing['call_ms']:.5f}",
        plain_call_ms=f"{timing['plain_call_ms']:.5f}", card=repr(card))


def _check_err(name: str, out, ref, limit: float, relative: bool = False, **case) -> float:
    """max |out - ref| against `limit`; with `relative`, each element's
    error is first divided by max(1, |ref|) (one bf16 step grows with the
    output's magnitude). Returns the max absolute error."""
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    bound = (diff / ref.float().abs().clamp_min(1.0)).max().item() if relative else err
    if not np.isfinite(err) or bound > limit:
        raise AssertionError(f"{name} {case}: max|err|={err} (checked {bound}) > {limit}")
    log("kernel", name=name, **case, max_abs_err=f"{err:.3e}",
        **({"max_err_over_max1_ref": f"{bound:.3e}"} if relative else {}), limit=limit)
    return err


def _batch_holes(b: int) -> torch.Tensor:
    """A different dead range [lo, hi) per row, some empty, as ragged text
    gives (the CFG rows repeat the utterance rows' holes). The holes lie in
    [70, 124), so every (start, cache_pos) case keeps a live slot in every
    row, as the path does (the plain version's softmax of a row with no
    live slot is NaN; the kernel gives 0)."""
    u = b // 2
    lo = [70 + 3 * r for r in range(u)]
    hi = [lo[r] + (0 if r % 3 == 0 else 4 * r + 5) for r in range(u)]
    holes = [[l, h] for l, h in zip(lo, hi)] * 2
    return torch.tensor(holes, dtype=torch.int32, device="cuda")


def phase_kernel_check(card: str) -> dict:
    """flash_decode kernel vs decode_attention_reference on the card."""
    from chatterbox_embed_tpu_torch.kernels import flash_decode as fd
    g = torch.Generator(device="cuda").manual_seed(1234)
    h, d = KERNEL_H, KERNEL_D
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    timing = {}
    for b in (KERNEL_B, KERNEL_B_BATCH):
        for lc in KERNEL_LC:
            # (start, cache_pos) pairs: inside one split, across split edges,
            # a start on an edge, the last slot, and the smoke's decode range
            cases = [(0, 0), (3, 40), (10, 63), (63, 64), (64, 300), (130, 381),
                     (5, lc - 1)]
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
                k = torch.randn((lc, b, h, d), generator=g, device="cuda").to(dtype)
                v = torch.randn((lc, b, h, d), generator=g, device="cuda").to(dtype)
                if b == KERNEL_B:
                    holes = [None, torch.tensor([[0, 0], [70, 200]], dtype=torch.int32,
                                                device="cuda")]
                else:
                    holes = [_batch_holes(b)]
                for hole in holes:
                    for start, pos in cases:
                        out = fd.decode_attention(q, k, v, pos, start, hole)
                        ref = fd.decode_attention_reference(q, k, v, pos, start, hole)
                        err = _check_err("flash_decode", out, ref, TOL[dtype], b=b, lc=lc,
                                         dtype=str(dtype)[6:], start=start, pos=pos,
                                         hole=hole is not None)
                        worst[dtype] = max(worst[dtype], err)
                if dtype == torch.bfloat16:
                    # time at the decode step's shape: the live range the main
                    # path reaches mid-generation
                    start, pos = 4, min(lc - 1, 4 + (lc - 4) * 3 // 4)
                    hole = holes[-1]
                    t = _timing(lambda: fd.decode_attention(q, k, v, pos, start, hole),
                                lambda: fd.decode_attention_reference(q, k, v, pos, start,
                                                                      hole))
                    timing[(b, lc)] = t
                    _log_time("flash_decode", t, card, b=b, lc=lc, start=start, pos=pos,
                              hole=hole is not None)
    # the JSON line reports the batched path's shape: 8 utterances, Lc 512
    return {"max_abs_err": worst[torch.bfloat16], "max_abs_err_fp32": worst[torch.float32],
            "timing": timing[(KERNEL_B_BATCH, KERNEL_LC[0])]}


def _ragged_valid(b: int, t: int, g, empty_row: bool) -> torch.Tensor:
    """Key masks: row 0 all valid, row 1 a single valid key, row 2 none
    (when `empty_row`), the rest random valid lengths."""
    lens = torch.randint(1, t + 1, (b,), generator=g, device="cuda")
    lens[0], lens[1] = t, 1
    if empty_row:
        lens[2] = 0
    return torch.arange(t, device="cuda")[None] < lens[:, None]


def phase_attention_check(card: str) -> dict:
    """K2 and K3 against their plain versions on the card."""
    from chatterbox_embed_tpu_torch.kernels import flash_attention as fa
    from chatterbox_embed_tpu_torch.kernels import rel_attention as ra
    g = torch.Generator(device="cuda").manual_seed(4321)
    result = {}
    scale = 1.0 / ATT_D ** 0.5
    specs = [
        ("rel_attention", REL_SHAPES, REL_TIMED, REL_DA, True,
         lambda q, k, v, m: ra.rel_attention(q, k, v, m, scale),
         lambda q, k, v, m: ra.rel_attention_reference(q, k, v, m, scale)),
        ("flash_attention", FLASH_SHAPES, FLASH_TIMED, ATT_D, False,
         fa.flash_attention, fa.flash_attention_reference),
    ]
    for name, shapes, timed, da, empty_row, kernel, plain in specs:
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        timing = {}
        for b, t in shapes:
            valid = _ragged_valid(b, t, g, empty_row)
            for dtype in (torch.float32, torch.bfloat16):
                q = torch.randn((b, t, ATT_H, da), generator=g, device="cuda").to(dtype)
                k = torch.randn((b, t, ATT_H, da), generator=g, device="cuda").to(dtype)
                v = torch.randn((b, t, ATT_H, ATT_D), generator=g, device="cuda").to(dtype)
                out = kernel(q, k, v, valid)
                ref = plain(q, k, v, valid)
                err = _check_err(name, out, ref, ATT_TOL[dtype], dtype == torch.bfloat16,
                                 b=b, t=t, h=ATT_H, da=da, dtype=str(dtype)[6:])
                worst[dtype] = max(worst[dtype], err)
                if empty_row:
                    zero = out[2].float().abs().max().item()
                    if zero != 0.0:
                        raise AssertionError(f"{name}: the row without a valid key "
                                             f"gave max|out|={zero}, not 0")
                if dtype == torch.bfloat16 and (b, t) in timed:
                    tm = _timing(lambda: kernel(q, k, v, valid), lambda: plain(q, k, v, valid),
                                 iters=20)
                    timing[(b, t)] = tm
                    _log_time(name, tm, card, b=b, t=t, h=ATT_H, da=da)
                del q, k, v, out, ref
        torch.cuda.empty_cache()
        result[name] = {"max_abs_err": worst[torch.bfloat16],
                        "max_abs_err_fp32": worst[torch.float32],
                        "timing": timing[timed[0]]}
    return result


def _random_conds(cfg, device, n_s3gen_prompt=None, seed=0):
    """Conditionals shaped like a prepared 10 s voice: speaker embedding,
    150 prompt speech tokens, 300 prompt mel frames, x-vector.
    n_s3gen_prompt shortens the S3Gen prompt (tokens and mel frames)."""
    from chatterbox_embed_tpu_torch.conditionals import Conditionals
    from chatterbox_embed_tpu_torch.models.t3 import T3Cond
    rng = np.random.default_rng(seed)
    n_prompt = cfg.t3.speech_cond_prompt_len
    n_gen = n_s3gen_prompt or n_prompt
    t3c = T3Cond(
        speaker_emb=torch.tensor(rng.standard_normal((1, cfg.t3.speaker_embed_size)),
                                 dtype=torch.float32),
        cond_prompt_speech_tokens=torch.tensor(rng.integers(0, 6561, (1, n_prompt)),
                                               dtype=torch.int32),
        emotion_adv=0.5)
    gen = dict(prompt_token=rng.integers(0, 6561, (1, n_gen)).astype(np.int64),
               prompt_token_len=np.array([n_gen], np.int64),
               prompt_feat=rng.standard_normal((1, 2 * n_gen, cfg.s3gen.mel_num)
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


def phase_batch_consistency(tts) -> None:
    """Full width, fp32: the conformer on 8 ragged rows (through K2) against
    each row alone (1 row, factored branch), and the CFM estimator on 16 CFG
    rows (through K3) against each cond/uncond pair alone (2 rows, written-
    out attention), at valid positions."""
    from chatterbox_embed_tpu_torch.kernels import flash_attention as fa
    from chatterbox_embed_tpu_torch.kernels import rel_attention as ra
    from chatterbox_embed_tpu_torch.models import conformer, flow_decoder
    from chatterbox_embed_tpu_torch.weights import place
    flow_cfg = tts.cfg.s3gen.flow
    flow = place(tts.s3gen_params["flow"], "cuda", torch.float32)
    g = torch.Generator(device="cuda").manual_seed(11)
    u, t_tok = 8, 406
    lens = torch.tensor([406, 380, 300, 271, 250, 200, 161, 150], device="cuda")
    x = torch.randn((u, t_tok, flow_cfg.encoder.input_size), generator=g, device="cuda")
    with torch.no_grad():
        launches = ra.rel_attention.launches
        batch = conformer.forward(flow["encoder"], x, lens, flow_cfg.encoder, torch.float32)
        if ra.rel_attention.launches - launches != 10:
            raise AssertionError("the 8-row conformer did not run its 10 blocks through K2")
        err = 0.0
        for i in range(u):
            n = 2 * int(lens[i])
            solo = conformer.forward(flow["encoder"], x[i:i + 1], lens[i:i + 1],
                                     flow_cfg.encoder, torch.float32)
            err = max(err, (batch[i, :n] - solo[0, :n]).abs().max().item())
    torch.cuda.synchronize()
    if not np.isfinite(err) or err > BATCH_TOL:
        raise AssertionError(f"conformer batch vs solo: max|err|={err} > {BATCH_TOL}")
    log("batch_check", module="conformer", rows=u, t_tokens=t_tok, dtype="float32",
        max_abs_err=f"{err:.3e}", limit=BATCH_TOL)

    dec_cfg = flow_cfg.decoder
    t_mel = 2 * t_tok
    mel_lens = 2 * lens
    mask = (torch.arange(t_mel, device="cuda")[None, :, None] < mel_lens[:, None, None]).float()
    xs = torch.randn((u, t_mel, 80), generator=g, device="cuda")
    mu = torch.randn((u, t_mel, 80), generator=g, device="cuda")
    cond = torch.randn((u, t_mel, 80), generator=g, device="cuda") * mask
    spks = torch.randn((u, 80), generator=g, device="cuda")
    tt = torch.rand((u,), generator=g, device="cuda")
    zeros = torch.zeros_like

    def pair(sl):
        # rows [cond; uncond] as cfm.solve_euler lays them out
        return (torch.cat([xs[sl], xs[sl]]), torch.cat([mu[sl], zeros(mu[sl])]),
                torch.cat([tt[sl], tt[sl]]), torch.cat([spks[sl], zeros(spks[sl])]),
                torch.cat([cond[sl], zeros(cond[sl])]), torch.cat([mask[sl], mask[sl]]))

    with torch.no_grad():
        launches = fa.flash_attention.launches
        batch = flow_decoder.forward(flow["decoder"], *pair(slice(0, u)), dec_cfg, torch.float32)
        n_tblocks = (2 + dec_cfg.num_mid_blocks) * dec_cfg.n_blocks
        if fa.flash_attention.launches - launches != n_tblocks:
            raise AssertionError(f"the 16-row estimator did not run its {n_tblocks} "
                                 f"transformer blocks through K3")
        err, scale = 0.0, batch.abs().max().item()
        for i in range(u):
            solo = flow_decoder.forward(flow["decoder"], *pair(slice(i, i + 1)), dec_cfg,
                                        torch.float32)
            n = int(mel_lens[i])
            for r, s in ((i, 0), (u + i, 1)):
                err = max(err, (batch[r, :n] - solo[s, :n]).abs().max().item())
    torch.cuda.synchronize()
    if not np.isfinite(err) or err > BATCH_TOL:
        raise AssertionError(f"estimator batch vs solo: max|err|={err} > {BATCH_TOL}")
    log("batch_check", module="flow_decoder", rows=2 * u, t_mel=t_mel, dtype="float32",
        max_abs_err=f"{err:.3e}", max_abs_out=f"{scale:.3f}", limit=BATCH_TOL)
    del flow
    torch.cuda.empty_cache()


def _reset_counts() -> None:
    for _, wrapper, _ in _kernels().values():
        wrapper.launches = 0


def _counts() -> dict:
    return {name: wrapper.launches for name, (_, wrapper, _) in _kernels().items()}


def phase_generate(card: str, tts) -> dict:
    cfg = tts.cfg
    for run in ("warmup", "timed"):
        _reset_counts()
        wav = tts.generate(TEXT, max_new_tokens=250, cfg_weight=0.5,
                           temperature=0.7, seed=0)
        counts = _counts()
        perf = dict(tts.perf)
        n_tok = perf["speech_tokens"]
        steps = perf["decode_steps"]
        if wav.ndim != 2 or wav.shape[0] != 1 or wav.shape[1] != 2 * n_tok * 480:
            raise AssertionError(f"wav shape {wav.shape}, want (1, {2 * n_tok * 480})")
        if not np.isfinite(wav).all():
            raise AssertionError("wav has non-finite samples")
        launches = counts["flash_decode"]
        if launches != cfg.t3.llama.num_layers * steps or steps == 0:
            raise AssertionError(f"flash_decode launched {launches} times for {steps} "
                                 f"decode steps x {cfg.t3.llama.num_layers} layers")
        log("generate", run=run, tokens=n_tok, decode_steps=steps,
            flash_decode_launches=launches, wav_samples=wav.shape[1],
            peak_abs=f"{float(np.abs(wav).max()):.4f}",
            t3_s=f"{perf['t3_s']:.4f}", s3gen_s=f"{perf['s3gen_s']:.4f}",
            tokens_per_s=f"{perf['tokens_per_s']:.2f}", rtf=f"{perf['rtf']:.4f}",
            card=repr(card))
    return counts


def phase_generate_batch(card: str, tts, conds, label: str) -> dict:
    """generate_batch on the 8 texts with `conds` (one voice or a list);
    checks each wav and the launch counts of the path."""
    from chatterbox_embed_tpu_torch.models.cfm import reuse_flags
    cfg = tts.cfg
    n_layers = cfg.t3.llama.num_layers
    n_blocks = cfg.s3gen.flow.encoder.num_blocks + cfg.s3gen.flow.encoder.num_up_blocks
    dec = cfg.s3gen.flow.decoder
    tblocks_fresh = (2 + dec.num_mid_blocks) * dec.n_blocks
    tblocks_reuse = 2 * dec.n_blocks
    for run in ("warmup", "timed"):
        _reset_counts()
        wavs = tts.generate_batch(TEXTS, conds=conds, **BATCH_KW)
        counts = _counts()
        perf = dict(tts.perf)
        if len(wavs) != len(TEXTS):
            raise AssertionError(f"{len(wavs)} wavs for {len(TEXTS)} texts")
        for i, (w, n) in enumerate(zip(wavs, perf["row_tokens"])):
            if w.ndim != 1 or w.shape[0] != 2 * n * 480 or n == 0:
                raise AssertionError(f"row {i}: wav shape {w.shape}, want ({2 * n * 480},)")
            if not np.isfinite(w).all():
                raise AssertionError(f"row {i}: wav has non-finite samples")
        steps, dispatches = perf["decode_steps"], perf["s3gen_dispatches"]
        flags = reuse_flags(cfg.s3gen.flow.cfm.n_timesteps, perf["cfm_cache_every"])
        reused = sum(flags)
        fresh = len(flags) - reused
        want = {"flash_decode": n_layers * steps,
                "rel_attention": n_blocks * dispatches,
                "flash_attention": dispatches * (tblocks_fresh * fresh + tblocks_reuse * reused)}
        if counts != want or steps == 0:
            raise AssertionError(f"{label}: launches {counts}, want {want}")
        if perf["s3gen_sub_batch"] != BATCH_SUB or perf["cfm_cache_every"] != BATCH_STRIDE:
            raise AssertionError(f"{label}: sub-batch {perf['s3gen_sub_batch']}, stride "
                                 f"{perf['cfm_cache_every']}; want {BATCH_SUB}, {BATCH_STRIDE}")
        log("generate_batch", voices=label, run=run, utterances=len(wavs),
            tokens=perf["speech_tokens"], row_tokens=",".join(map(str, perf["row_tokens"])),
            decode_steps=steps, decode_sub_batches=perf["decode_sub_batches"],
            s3gen_sub_batch=perf["s3gen_sub_batch"], s3gen_dispatches=dispatches,
            cfm_stride=perf["cfm_cache_every"], cfm_fresh_steps=fresh,
            cfm_reused_steps=reused, launches=json.dumps(counts).replace(" ", ""),
            t3_s=f"{perf['t3_s']:.4f}", s3gen_s=f"{perf['s3gen_s']:.4f}",
            tokens_per_s=f"{perf['tokens_per_s']:.2f}", audio_s=f"{perf['audio_s']:.3f}",
            batch_rtf=f"{perf['rtf']:.4f}", card=repr(card))
    return counts


if __name__ == "__main__":
    card = phase_device()
    phase_build()
    check = {"flash_decode": phase_kernel_check(card)}
    check.update(phase_attention_check(card))

    from chatterbox_embed_tpu_torch.config import ChatterboxConfig
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    cfg = ChatterboxConfig()
    t0 = time.time()
    tts = ChatterboxTTS.from_random(seed=0, config=cfg, dtype=torch.bfloat16, device="cuda")
    tts.conds = _random_conds(cfg, "cuda")
    torch.cuda.synchronize()
    log("model", config="ChatterboxConfig()", dtype="bfloat16",
        t3_layers=cfg.t3.llama.num_layers, d=cfg.t3.llama.hidden_size,
        init_s=f"{time.time() - t0:.2f}", text_chars=len(TEXT))
    phase_decode_consistency(tts)
    phase_batch_consistency(tts)
    launches = {"generate": phase_generate(card, tts)}
    launches["generate_batch"] = phase_generate_batch(card, tts, None, "one")
    voices = [_random_conds(cfg, "cuda", n, seed) for n, seed in ((150, 1), (110, 2))]
    launches["generate_batch_multi_voice"] = phase_generate_batch(
        card, tts, [voices[i % 2] for i in range(len(TEXTS))], "two")

    from chatterbox_embed_tpu_torch.kernels import _build
    replaces = {"flash_decode": "chatterbox_embed_tpu/kernels/flash_decode.py:85",
                "rel_attention": "chatterbox_embed_tpu/kernels/rel_attention.py:45",
                "flash_attention": "chatterbox_embed_tpu/models/layers.py:395"}
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": str(m.SOURCE.relative_to(_build.PKG.parent)),
        "replaces": replaces[name],
        "launches": launches["generate_batch"][name],
        "launches_by_path": {p: c[name] for p, c in launches.items()},
        "max_abs_err": check[name]["max_abs_err"],
        "max_abs_err_fp32": check[name]["max_abs_err_fp32"],
        "ms": check[name]["timing"]["ms"], "plain_ms": check[name]["timing"]["plain_ms"],
        "call_ms": check[name]["timing"]["call_ms"],
        "plain_call_ms": check[name]["timing"]["plain_call_ms"]}
        for name, (m, _, _) in _kernels().items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
