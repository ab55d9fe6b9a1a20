"""K9 (kernels/kda.py), K7 at Kimi-Linear's held share, and the hybrid
backbone's graphed engine step (models/t3_engine.py: EngineStep, one piece)
on the card.

- K9 against its plain loop (`kda_recurrent_reference`, fp32 on the card,
  TF32 off) at a decode step (32 rows, 32 heads of 128 x 128, one token,
  reading the state) and at a ~300-token prefill of 2 rows with left pads
  of 37 and 0 positions, from zero. Both are fp32 and take the same steps;
  only the order of the 128-term sums differs (the kernel's four partial
  sums against cuBLAS-free einsums), so the limit is 1e-5 of the norm of
  the output and of the state; a skipped position reads exactly 0. A
  dropped decay channel or beta forced to 1, planted, reads ~1e-1 or more.
- K9 captured in a CUDA graph (utils/graphs.py) on one state and inputs,
  replayed on another: the eager launch's bits, one launch a replay.
- K7 at D 2304, F 1024, 32 held experts: rows routed by a sigmoid router
  over 256 experts, top 8, only the held assignments sorted in; against the
  fp32 arithmetic on the same bf16 values with h rounded to bf16 as the
  kernel stores it (2e-3 of the norm: sums in another order and an h that
  rounds the other way; 1e-2 of each row's norm, so that a row written over
  a neighbour's or never written, ~1, shows).
- The engine at tts-backlog's geometry (16 slots, text bucket 256, 1000 new
  tokens, blocks of 64) on T3 with the published backbone's widths at 4
  layers (layer 0 dense, KDA at layers 1-3, MLA at layer 4, 32 of 256
  experts held): the graphed step gives the eager step's tokens, bit for
  bit (the same kernels in the same order on the same values).

The tests need a CUDA card and skip without one. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_kimi_linear_card.py
"""
import math
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chatterbox_embed_tpu_torch.config import T3Config
from chatterbox_embed_tpu_torch.kernels import kda, moe_experts
from chatterbox_embed_tpu_torch.models import deepseek_v2 as dsv2
from chatterbox_embed_tpu_torch.models import kimi_linear as kimi
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.models import t3, t3_engine
from chatterbox_embed_tpu_torch.utils import graphs
from chatterbox_embed_tpu_torch.weights import place

KIMI = kimi.KimiLinearConfig(experts_held=(0, 32))
GEO = dict(slots=16, text_bucket=256, max_new_tokens=1000, block=64)
SAMPLING = dict(temperature=0.6, cfg_weight=0.3, repetition_penalty=1.2, min_p=0.05)
HBM = 3.35e12
K9_TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


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


def _inputs(b, t, dev, gen, h=32, dk=128):
    """K9's inputs as a KDA layer makes them: q and k L2-normalised (q /
    sqrt(dk)), v after SiLU, log decays from A in [1, 16] times softplus of
    a dt-biased draw, beta a sigmoid; and a state of unit entries."""
    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    q = F.normalize(r(b, t, h, dk), dim=-1) / math.sqrt(dk)
    k = F.normalize(r(b, t, h, dk), dim=-1)
    v = F.silu(r(b, t, h, dk))
    a = 1 + 15 * torch.rand((h, 1), generator=gen, device=dev)
    g = -a * F.softplus(r(b, t, h, dk) - 4)
    beta = torch.sigmoid(r(b, t, h))
    return [x.contiguous() for x in (q, k, v, g, beta)], r(b, h, dk, dk)


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.card
@pytest.mark.parametrize("case", ["decode", "prefill"])
def test_k9_equals_its_plain_loop(card, case):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=card).manual_seed(9)
    b, t = (32, 1) if case == "decode" else (2, 300)
    (q, k, v, g, beta), s0 = _inputs(b, t, card, gen)
    read = case == "decode"
    skip = None if read else torch.tensor([37, 0], dtype=torch.int32, device=card)
    state, plain_state = s0.clone(), s0.clone()
    o = kda.kda_recurrent(q, k, v, g, beta, state, skip, read_state=read)
    plain = kda.kda_recurrent_reference(q, k, v, g, beta, plain_state, skip, read_state=read)
    assert _rel(o, plain) < K9_TOL and _rel(state, plain_state) < K9_TOL, (
        _rel(o, plain), _rel(state, plain_state))
    again = s0.clone()
    assert torch.equal(kda.kda_recurrent(q, k, v, g, beta, again, skip, read_state=read), o)
    if skip is not None:
        assert o[0, :37].abs().max() == 0
    # planted faults read far above the limit
    for name, args in (("decay channel dropped", (q, k, v, g.clone().index_fill_(3, torch.tensor(
            [0], device=card), 0.0), beta)), ("beta 1", (q, k, v, g, torch.ones_like(beta)))):
        st = s0.clone()
        bad = kda.kda_recurrent(*args, st, skip, read_state=read)
        assert max(_rel(bad, plain), _rel(st, plain_state)) > 100 * K9_TOL, name

    h, dk = q.shape[2], q.shape[3]
    tokens = b * t - (0 if skip is None else int(skip.sum()))
    nbytes = (b * h * (read + 1)) * dk * dk * 4 + tokens * h * (5 * dk + 1) * 4
    bound = 1e3 * max(nbytes / HBM, 7 * tokens * h * dk * dk / 67e12)
    st = s0.clone()
    k9 = _ms(lambda: kda.kda_recurrent(q, k, v, g, beta, st, skip, read_state=read))
    loop = _ms(lambda: kda.kda_recurrent_reference(q, k, v, g, beta, s0.clone(), skip,
                                                   read_state=read), reps=2)
    print(f"\n{torch.cuda.get_device_name(card)}: K9 {case} {b} rows x {t} tokens: {k9:.5f} ms; "
          f"plain loop {loop:.5f} ms; bound {bound:.5f} ms ({nbytes / 1e6:.1f} MB); "
          f"{100 * bound / k9:.1f} % of it; rel err {_rel(o, plain):.2e} "
          f"state {_rel(state, plain_state):.2e}")


@pytest.mark.card
def test_k9_replays_in_a_graph_on_another_state(card):
    gen = torch.Generator(device=card).manual_seed(10)
    (q, k, v, g, beta), s0 = _inputs(32, 1, card, gen)
    (q2, k2, v2, g2, beta2), s1 = _inputs(32, 1, card, gen)
    ins = [x.clone() for x in (q, k, v, g, beta)]
    state = s0.clone()
    graph = graphs.Graphed([lambda: kda.kda_recurrent(*ins, state)], card)
    graph.step()
    assert graph.launches == [{"kda_recurrent": 1}]
    for dst, src in zip(ins, (q2, k2, v2, g2, beta2)):
        dst.copy_(src)
    state.copy_(s1)
    n = kda.kda_recurrent.launches
    out = graph.step()
    torch.cuda.synchronize()
    assert kda.kda_recurrent.launches == n + 1
    want_state = s1.clone()
    want = kda.kda_recurrent(q2, k2, v2, g2, beta2, want_state)
    assert torch.equal(out, want) and torch.equal(state, want_state)


def _exact(xs, offsets, wg, wu, wd):
    """K7's arithmetic in fp32 from its bf16 inputs, h rounded to bf16."""
    off = offsets.tolist()
    y = torch.zeros((xs.shape[0], wd.shape[2]), dtype=torch.float32, device=xs.device)
    for e in range(wg.shape[0]):
        a, b = off[e], off[e + 1]
        if a < b:
            x = xs[a:b].float()
            h = (F.silu(x @ wg[e].float()) * (x @ wu[e].float())).bfloat16()
            y[a:b] = h.float() @ wd[e].float()
    return y


@pytest.mark.card
@pytest.mark.parametrize("tokens", [32, 584], ids=["decode", "prefill"])
def test_k7_at_the_held_share(card, tokens):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=card).manual_seed(tokens)
    d, f, e = KIMI.hidden_size, KIMI.moe_intermediate_size, 32

    def u(shape, fan):
        return ((torch.rand(shape, generator=gen, device=card) * 2 - 1)
                * math.sqrt(3.0 / fan)).to(torch.bfloat16)
    wg, wu, wd = u((e, d, f), d), u((e, d, f), d), u((e, f, d), f)
    x = torch.randn((tokens, d), generator=gen, device=card)
    lp = {"router": {"w": torch.randn((d, 256), generator=gen, device=card) / math.sqrt(d),
                     "e_score_correction_bias": 0.05 * torch.rand(256, device=card)}}
    ids, _ = dsv2.route(lp, x, KIMI)
    local = torch.where(ids < e, ids, e)
    order, _, offsets, counts = dsv2.sort_by_expert(local, e + 1)
    offsets, counts = offsets[:e + 1].contiguous(), counts[:e]
    xs = x[order // KIMI.num_experts_per_tok].to(torch.bfloat16).contiguous()
    held = int(offsets[-1])
    y = moe_experts.grouped_swiglu(xs, offsets, wg, wu, wd)[:held]
    want = _exact(xs, offsets, wg, wu, wd)[:held]
    assert _rel(y, want) < 2e-3, _rel(y, want)
    rows = torch.linalg.norm(y - want, dim=1) / torch.linalg.norm(want, dim=1)
    assert float(rows.max()) < 1e-2, float(rows.max())
    touched = int((counts > 0).sum())
    nbytes = touched * 3 * d * f * 2 + held * d * 6
    k7 = _ms(lambda: moe_experts.grouped_swiglu(xs, offsets, wg, wu, wd))
    print(f"\n{torch.cuda.get_device_name(card)}: K7 held share, {tokens} tokens x top 8 of 256: "
          f"{held} held assignments, {touched} of 32 experts touched: {k7:.5f} ms; bound "
          f"{1e3 * nbytes / HBM:.5f} ms ({100 * nbytes / HBM / (k7 / 1e3):.1f} %); "
          f"rel err {_rel(y, want):.2e}")


def _engine_inputs(dev):
    cfg = T3Config(llama=kimi.KimiLinearConfig(num_layers=4, kda_layers=(1, 2, 3),
                                               full_attn_layers=(4,), experts_held=(0, 32)))
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
    assert dec.pieces.whole
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
def test_graphed_hybrid_step_equals_the_eager_step(card):
    cfg, params, reqs = _engine_inputs(card)
    eager, want, t_eager = _drain(cfg, params, reqs, graphed=False)
    n = kda.kda_recurrent.launches
    dec, got, t_graphed = _drain(cfg, params, reqs, graphed=True)
    assert dec.pieces.graphs.captured
    assert dec.pieces.graphs.launches[0].get("kda_recurrent") == 3
    assert kda.kda_recurrent.launches - n == 3 * (dec.steps_run + len(reqs))
    assert (eager.steps_run, eager.blocks_run) == (dec.steps_run, dec.blocks_run)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    print(f"\n{torch.cuda.get_device_name(card)}: hybrid engine, 4 layers: {dec.steps_run} "
          f"steps; eager {1e3 * t_eager / eager.steps_run:.3f} ms a step, graphed "
          f"{1e3 * t_graphed / dec.steps_run:.3f}")
