"""K7 (kernels/moe_experts.py) and the latent backbone's graphed engine step
(models/t3_engine.py: WholeStep) on the card.

- K7 against the plain loop over the experts at DeepSeek-V2-Lite's widths
  (D 2048, F 1408, 64 experts), bf16, at a decode step's rows (32 x 6
  assignments) and a prefill's (584 x 6), routed by a random router; the
  reference is the same arithmetic in fp32 from the same bf16 values with h
  rounded to bf16 as the kernel stores it (2e-3 of the norm: sums in
  another order, and an h that rounds the other way). The kernel captured
  in a CUDA graph and replayed on new rows and offsets gives the eager
  launch's bits. Times by CUDA events: K7, the plain loop and K7's bound.
- The engine at tts-backlog's geometry (16 slots, text bucket 256, 1000 new
  tokens, blocks of 64) on T3 with the published backbone's widths at 4
  layers (1 dense, 3 MoE): the graphed step gives the eager step's tokens,
  bit for bit.

The tests need a CUDA card and skip without one. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_dsv2_card.py
"""
import math
import time

import numpy as np
import pytest
import torch

from chatterbox_embed_tpu_torch.config import T3Config
from chatterbox_embed_tpu_torch.kernels import moe_experts
from chatterbox_embed_tpu_torch.models import deepseek_v2 as dsv2
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.models import t3, t3_engine
from chatterbox_embed_tpu_torch.utils import profiling
from chatterbox_embed_tpu_torch.weights import place

LITE = dsv2.DeepseekV2Config()
GEO = dict(slots=16, text_bucket=256, max_new_tokens=1000, block=64)
SAMPLING = dict(temperature=0.6, cfg_weight=0.3, repetition_penalty=1.2, min_p=0.05)
HBM = 3.35e12


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


def _experts(dev, gen):
    e, d, f = LITE.n_routed_experts, LITE.hidden_size, LITE.moe_intermediate_size

    def u(shape, fan):
        return ((torch.rand(shape, generator=gen, device=dev) * 2 - 1)
                * math.sqrt(3.0 / fan)).to(torch.bfloat16)
    return u((e, d, f), d), u((e, d, f), d), u((e, f, d), f)


def _routed(tokens, dev, gen):
    x = torch.randn((tokens, LITE.hidden_size), generator=gen, device=dev)
    router = torch.randn((LITE.hidden_size, LITE.n_routed_experts), generator=gen,
                         device=dev) / math.sqrt(LITE.hidden_size)
    ids = torch.topk(x @ router, LITE.num_experts_per_tok, dim=-1).indices
    order, _, offsets, counts = dsv2.sort_by_expert(ids, LITE.n_routed_experts)
    xs = x[order // LITE.num_experts_per_tok].to(torch.bfloat16).contiguous()
    return xs, offsets, counts


def _exact(xs, offsets, wg, wu, wd):
    """K7's arithmetic in fp32 from the bf16 values, h rounded to bf16."""
    off = offsets.tolist()
    y = torch.zeros((xs.shape[0], wd.shape[2]), dtype=torch.float32, device=xs.device)
    for e in range(wg.shape[0]):
        a, b = off[e], off[e + 1]
        if a < b:
            x = xs[a:b].float()
            h = (torch.nn.functional.silu(x @ wg[e].float()) * (x @ wu[e].float())).bfloat16()
            y[a:b] = h.float() @ wd[e].float()
    return y


def _ms(fn, reps=20):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.card
@pytest.mark.parametrize("tokens", [32, 584], ids=["decode", "prefill"])
def test_k7_equals_the_plain_loop_and_replays_in_a_graph(card, tokens):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=card).manual_seed(tokens)
    wg, wu, wd = _experts(card, gen)
    xs, offsets, counts = _routed(tokens, card, gen)
    y = moe_experts.grouped_swiglu(xs, offsets, wg, wu, wd)
    want = _exact(xs, offsets, wg, wu, wd)
    rel = float(torch.linalg.norm(y - want) / torch.linalg.norm(want))
    plain = moe_experts.grouped_swiglu_reference(xs, offsets, wg, wu, wd)
    rel_plain = float(torch.linalg.norm(plain - want) / torch.linalg.norm(want))
    assert rel < 2e-3, rel

    # a graph captured on one routing, replayed on another
    xs2, offsets2, _ = _routed(tokens, card, gen)
    sx, so = xs.clone(), offsets.clone()
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        moe_experts.grouped_swiglu(sx, so, wg, wu, wd)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gy = moe_experts.grouped_swiglu(sx, so, wg, wu, wd)
    sx.copy_(xs2)
    so.copy_(offsets2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(gy, moe_experts.grouped_swiglu(xs2, offsets2, wg, wu, wd))

    touched = int((counts > 0).sum())
    n = xs.shape[0]
    d, f = LITE.hidden_size, LITE.moe_intermediate_size
    nbytes = touched * 3 * d * f * 2 + n * (d * 2 + d * 4)
    ops = 6 * d * f * n
    bound = 1e3 * max(nbytes / HBM, ops / 989e12)
    k7 = _ms(lambda: moe_experts.grouped_swiglu(xs, offsets, wg, wu, wd))
    loop = _ms(lambda: moe_experts.grouped_swiglu_reference(xs, offsets, wg, wu, wd), reps=3)
    print(f"\n{torch.cuda.get_device_name(card)}: K7 at {n} assignments, {touched} experts "
          f"touched, max {int(counts.max())} rows: {k7:.5f} ms; plain loop {loop:.5f} ms; bound "
          f"{bound:.5f} ms ({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); {100 * bound / k7:.1f} "
          f"% of it; rel err {rel:.2e} (plain loop in bf16 {rel_plain:.2e})")


def _inputs(dev, layers):
    cfg = T3Config(llama=dsv2.DeepseekV2Config(num_layers=layers))
    rng = np.random.default_rng(0)
    params = place(t3.init(L.Init(0, dev), cfg), dev, torch.bfloat16)
    conds = [t3.T3Cond(torch.tensor(rng.standard_normal((1, cfg.speaker_embed_size)),
                                    dtype=torch.float32, device=dev),
                       torch.tensor(rng.integers(0, cfg.start_speech_token,
                                                 (1, cfg.speech_cond_prompt_len)),
                                    dtype=torch.int32, device=dev), 0.5)
             for _ in range(2)]
    reqs = []
    for r in range(24):
        body = rng.integers(1, cfg.text_tokens_dict_size, int(rng.integers(20, 250)))
        text = np.concatenate([[cfg.start_text_token], body, [cfg.stop_text_token]])
        reqs.append((text[None].astype(np.int32), conds[r % 2], 1000 + r,
                     int(rng.integers(30, 160))))
    return cfg, params, reqs


def _drain(cfg, params, reqs, graphed: bool):
    dec = t3_engine.ContinuousDecoder(params, cfg, dtype=torch.bfloat16, device="cuda",
                                      route_record=True, **GEO)
    assert isinstance(dec.pieces, t3_engine.WholeStep)
    if not graphed:
        dec.pieces = None
    rids = [dec.submit(text, cond, seed=seed, max_new_tokens=cap, **SAMPLING)
            for text, cond, seed, cap in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dec.drain()
    torch.cuda.synchronize()
    return dec, [out[r] for r in rids], time.perf_counter() - t0


@pytest.mark.card
def test_graphed_latent_step_equals_the_eager_step(card):
    cfg, params, reqs = _inputs(card, layers=4)
    eager, want, t_eager = _drain(cfg, params, reqs, graphed=False)
    profiling.reset()
    profiling.enable()
    try:
        dec, got, t_graphed = _drain(cfg, params, reqs, graphed=True)
        totals = profiling.totals()
    finally:
        profiling.disable()
        profiling.reset()
    for r, (a, b) in enumerate(zip(want, got, strict=True)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {r}")
    assert (dec.steps_run, dec.blocks_run) == (eager.steps_run, eager.blocks_run)
    assert totals["counters"]["engine.graphed_steps"] == dec.steps_run - 1
    assert totals["spans"]["engine.capture"]["calls"] == 1
    for rid in eager.routes:
        np.testing.assert_array_equal(dec.routes[rid], eager.routes[rid])
    # every MoE layer of every step (prefills and replays) counted on the device
    moe_calls = totals["counters"]["moe.calls"]
    assert moe_calls == cfg.llama.moe_layers * (dec.steps_run + len(reqs))
    print(f"\n{torch.cuda.get_device_name(card)}: {dec.steps_run} steps, eager "
          f"{1e3 * t_eager / eager.steps_run:.2f} ms a step, graphed "
          f"{1e3 * t_graphed / dec.steps_run:.2f} (capture included), pool "
          f"{dec.pieces.pool_bytes / 2**20:.1f} MiB; experts touched a call "
          f"{totals['counters']['moe.experts_touched'] / moe_calls:.1f}")
