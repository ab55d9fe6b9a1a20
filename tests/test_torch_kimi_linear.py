"""T3 with a Kimi-Linear backbone (models/kimi_linear.py) against the plain
fp32 reference `tests/kimi_linear_reference.py`, on the CPU at a tiny size
that keeps every mechanism: d 64, 3 layers (layer 0 dense; KDA layers 1
and 2 in the config's 1-indexed count, MLA layer 3, unrotated), KDA 4
heads of 16 with a conv of 4, MLA 4 heads (nope 16 + 8, latent 32, v 16),
16 routed experts of which 8 held here, top 4, sigmoid-scored with a
correction bias, 1 shared.

- prefill then decode through the hybrid cache equals the reference's
  full forward, on logits (1e-4 relative: fp32 against fp32, sums in
  another order), and so does the teacher-forced forward;
- one request at two left pads gives the same logits (the pad enters
  neither the KDA state nor the conv window);
- a slot refilled after another request equals a fresh engine;
- a finished slot feeds no state: the state in its routing record
  (`KdaRoute`) is the one it finished with, as when it runs alone;
- the held shares of all ranks, the shared expert counted once, sum to
  the uncut reference layer; the router matches the reference's, near-ties
  planted, and with the routing forced;
- K9's plain path (kernels/kda.py) equals the delta rule written row by
  row, its skipped positions untouched;
- the device counters count K9's calls, row-tokens and states;
- DeepSeek-V2's `route` and `moe` give today's outputs bit for bit;
- every feature the backbone does not run raises through `backbone.check`.
"""
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import kimi_linear_reference as ref
from chatterbox_embed_tpu_torch import kernels, tts
from chatterbox_embed_tpu_torch.config import T3Config
from chatterbox_embed_tpu_torch.kernels import _build, kda
from chatterbox_embed_tpu_torch.models import backbone
from chatterbox_embed_tpu_torch.models import deepseek_v2 as dsv2
from chatterbox_embed_tpu_torch.models import kimi_linear as kimi
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.models import t3, t3_engine
from chatterbox_embed_tpu_torch.utils import profiling

torch.set_num_threads(2)

HF = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
      "num_key_value_heads": 4, "q_lora_rank": None, "kv_lora_rank": 32,
      "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16, "mla_use_nope": True,
      "linear_attn_config": {"kda_layers": [1, 2], "full_attn_layers": [3], "num_heads": 4,
                             "head_dim": 16, "short_conv_kernel_size": 4},
      "intermediate_size": 96, "moe_intermediate_size": 32, "num_experts": 8,
      "published_num_experts": 16, "num_shared_experts": 1, "num_experts_per_token": 4,
      "first_k_dense_replace": 1, "moe_layer_freq": 1, "routed_scaling_factor": 2.446,
      "moe_renormalize": True, "moe_router_activation_func": "sigmoid", "num_expert_group": 1,
      "topk_group": 1, "rms_norm_eps": 1e-5, "rope_scaling": None, "hidden_act": "silu",
      "model_type": "kimi_linear"}
CFG = kimi.from_hf_config(HF)
HELD = (0, 8)
T3C = T3Config(llama=CFG, max_text_tokens=64, max_speech_tokens=128, speech_cond_prompt_len=8)
RTOL = 1e-4
SAMPLING = dict(temperature=0.6, cfg_weight=0.3, repetition_penalty=1.2, min_p=0.05)


@pytest.fixture(scope="module")
def params():
    return t3.init(L.Init(0, "cpu"), T3C)


def _cond(rng):
    return t3.T3Cond(torch.tensor(rng.standard_normal((1, 256)), dtype=torch.float32),
                     torch.tensor(rng.integers(0, 6561, (1, 8)), dtype=torch.int32), 0.5)


def _text(rng, n):
    body = rng.integers(1, T3C.text_tokens_dict_size, n)
    return np.concatenate([[T3C.start_text_token], body, [T3C.stop_text_token]])[None].astype(
        np.int32)


def _close(got, want, rtol=RTOL):
    got, want = got.float(), want.float()
    assert torch.linalg.norm(got - want) <= rtol * torch.linalg.norm(want), (
        float(torch.linalg.norm(got - want) / torch.linalg.norm(want)))


def test_the_config_reads_the_published_keys():
    assert CFG.kinds == ("kda", "kda", "mla")
    assert (CFG.n_routed_experts, CFG.experts_held, CFG.num_experts_per_tok) == (16, HELD, 4)
    full = kimi.KimiLinearConfig()
    assert full.kinds.count("kda") == 20 and full.kinds.count("mla") == 7
    assert [i + 1 for i, k in enumerate(full.kinds) if k == "mla"] == [4, 8, 12, 16, 20, 24, 27]
    assert full.softmax_scale == pytest.approx(192 ** -0.5)
    with pytest.raises(ValueError, match="mla_use_nope"):
        kimi.from_hf_config(dict(HF, mla_use_nope=False))
    with pytest.raises(ValueError, match="share out"):
        kimi.from_hf_config(dict(HF, linear_attn_config=dict(HF["linear_attn_config"],
                                                              full_attn_layers=[2])))


def test_prefill_then_decode_matches_the_full_forward(params):
    torch.manual_seed(2)
    b, t_all, t_pre = 2, 40, 24
    x = torch.randn(b, t_all, CFG.hidden_size)
    want, _ = ref.backbone(params["llama"], x, HF, held=HELD)
    cache = kimi.init_cache(CFG, b, 64, torch.float32, "cpu")
    pos = torch.arange(t_all)[None].expand(b, t_all)
    got = [kimi.forward(params["llama"], x[:, :t_pre], pos[:, :t_pre], cache=cache,
                        cache_pos=0, cfg=CFG)[0]]
    for i in range(t_pre, t_all):
        got.append(kimi.forward(params["llama"], x[:, i:i + 1], pos[:, i:i + 1], cache=cache,
                                cache_pos=i, cfg=CFG)[0])
    head = params["speech_head"]["w"]
    _close(torch.cat(got, 1) @ head, want @ head)


def test_teacher_forced_forward_matches_the_reference(params):
    rng = np.random.default_rng(1)
    cond = _cond(rng)
    text = torch.tensor(rng.integers(1, 704, (2, 10)), dtype=torch.int32)
    speech = torch.tensor(rng.integers(0, 6561, (2, 12)), dtype=torch.int32)
    lens_t, lens_s = torch.tensor([10, 10]), torch.tensor([12, 12])
    tl, sl = t3.forward(params, cond, text, lens_t, speech, lens_s, cfg=T3C)
    x, _, mask, widths = t3._train_context(params, cond, text, lens_t, speech, lens_s, T3C)
    h, _ = ref.backbone(params["llama"], x, HF, mask=mask, held=HELD)
    lc, lt, ls = widths
    _close(tl, h[:, lc - 1:lc - 1 + lt] @ params["text_head"]["w"])
    _close(sl, h[:, lc + lt - 1:lc + lt - 1 + ls] @ params["speech_head"]["w"])


@pytest.mark.parametrize("pads", [(0, 9), (3, 17)])
def test_one_request_at_two_left_pads_gives_the_same_logits(params, pads):
    rng = np.random.default_rng(3)
    cond, text = _cond(rng), _text(rng, 12)
    lt = text.shape[1]
    out = []
    for pad in pads:
        p_len, _ = t3_engine.engine_geometry(T3C, lt + pad, 2 + T3C.perceiver_num_queries, 0)
        st, got_pad = t3_engine.prefill_request(params, cond, text, text_bucket=lt + pad,
                                                p_len=p_len, cfg=T3C, device="cpu")
        assert got_pad == pad
        out.append(st)
    _close(out[0].logits, out[1].logits, 1e-5)
    for a, b in zip(out[0].cache.kda, out[1].cache.kda):
        _close(b, a, 1e-5)
    _close(out[1].cache.conv, out[0].cache.conv, 1e-5)


def _decoder(params, slots=2):
    return t3_engine.ContinuousDecoder(params, T3C, slots=slots, text_bucket=32,
                                       max_new_tokens=30, block=8, device="cpu",
                                       route_record=True)


def _request(seed):
    rng = np.random.default_rng(seed)
    return _text(rng, int(rng.integers(5, 20))), _cond(rng)


@pytest.mark.parametrize("eager", [False, True], ids=["pieces", "eager"])
def test_a_refilled_slot_equals_a_fresh_engine(params, eager):
    """One slot: a request, then a second in the slot it freed, against the
    second alone on a fresh engine (tokens, and the logits and states the
    step leaves)."""
    used = _decoder(params, slots=1)
    fresh = _decoder(params, slots=1)
    if eager:
        used.pieces = fresh.pieces = None
    (t1, c1), (t2, c2) = _request(11), _request(12)
    used.submit(t1, c1, seed=5, max_new_tokens=20, **SAMPLING)
    used.drain()
    r2 = used.submit(t2, c2, seed=6, max_new_tokens=14, **SAMPLING)
    f2 = fresh.submit(t2, c2, seed=6, max_new_tokens=14, **SAMPLING)
    np.testing.assert_array_equal(used.drain()[r2], fresh.drain()[f2])
    # the same work, its MLA keys at other ring columns: sums in another order
    torch.testing.assert_close(used.state.cache.kda, fresh.state.cache.kda, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(used.state.logits, fresh.state.logits, rtol=1e-5, atol=1e-5)


def test_a_finished_slot_feeds_no_state_and_its_record_holds_it(params):
    """Request A ends in the first block while B runs on: A's rows keep the
    state they finished with to the block's end, its record holds that
    state, and it equals A's alone, whose block ends with it."""
    (ta, ca), (tb, cb) = _request(40), _request(41)
    both = _decoder(params)
    ra = both.submit(ta, ca, seed=7, max_new_tokens=5, **SAMPLING)
    both.submit(tb, cb, seed=8, max_new_tokens=20, **SAMPLING)
    assert list(both.step()) == [ra] and both.steps_run == 8
    alone = _decoder(params, slots=1)
    r1 = alone.submit(ta, ca, seed=7, max_new_tokens=5, **SAMPLING)
    alone.drain()
    assert alone.steps_run < 8
    got, want = both.routes[ra], alone.routes[r1]
    assert isinstance(got, t3_engine.KdaRoute)
    assert torch.equal(got.kda_state, both.state.cache.kda[0][[0, 2]])
    np.testing.assert_array_equal(got.ids, want.ids)
    torch.testing.assert_close(got.kda_state, want.kda_state, rtol=1e-5, atol=1e-6)


def test_the_engine_step_in_one_piece_gives_the_eager_steps_tokens(params):
    outs = []
    for eager in (False, True):
        dec = _decoder(params)
        assert dec.pieces.whole
        if eager:
            dec.pieces = None
        rids = [dec.submit(*_request(20 + k), seed=30 + k, max_new_tokens=10 + 4 * k,
                           **SAMPLING) for k in range(4)]
        done = dec.drain()
        outs.append([done[r] for r in rids])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_lock_step_generate_runs_the_hybrid_backbone(params):
    rng = np.random.default_rng(9)
    toks = t3.generate(params, _cond(rng), _text(rng, 8), max_new_tokens=10, cfg_weight=0.3,
                       cfg=T3C, device="cpu")
    assert 0 < np.asarray(toks).size <= 11


def test_ragged_rows_of_one_batch_raise(params):
    rng = np.random.default_rng(10)
    cond = _cond(rng)
    texts = np.concatenate([_text(rng, 8), _text(rng, 8)])
    with pytest.raises(ValueError, match="ragged rows"):
        t3.start_generation(params, cond, texts, cfg_weight=0.3, max_new_tokens=8,
                            text_lens=np.array([10, 6]), cfg=T3C, device="cpu")


def _layer_with_ties(params, j=1):
    lp = dict(params["llama"]["layers"][j])
    w = lp["router"]["w"].clone()
    bias = lp["router"]["e_score_correction_bias"].clone()
    w[:, 5] = w[:, 2] + 1e-7 * torch.randn(w.shape[0])     # experts 2 and 5 tie to ~1e-7
    bias[5] = bias[2]
    lp["router"] = {"w": w, "e_score_correction_bias": bias}
    return lp


def test_the_sigmoid_router_with_its_bias_matches_the_reference(params):
    torch.manual_seed(4)
    lp = _layer_with_ties(params)
    x = torch.randn(64, CFG.hidden_size)
    ids, w = dsv2.route(lp, x, CFG)
    ids_r, w_r, _, choice = ref.route(lp, x, HF)
    top = choice.sort(-1, descending=True).values
    clear = (top[:, 3] - top[:, 4]) > 1e-5
    assert clear.sum() > 40
    assert torch.equal(ids[clear].sort(-1).values, ids_r[clear].sort(-1).values)
    torch.testing.assert_close(w.sum(-1), torch.full((64,), 2.446), rtol=1e-6, atol=1e-6)
    order = ids.argsort(-1)
    order_r = ids_r.argsort(-1)
    _close(w.gather(1, order)[clear], w_r.gather(1, order_r)[clear], 1e-6)
    # the tied pair forced the other way round costs nothing
    forced = ids_r.clone()
    forced[ids_r == 2], forced[ids_r == 5] = 5, 2
    forced = torch.where((forced[:, :, None] == forced[:, None, :]).sum((1, 2)) > 4,
                         ids_r.T, forced.T).T
    y, got = dsv2.moe(lp, x, CFG, torch.float32, ids=forced)
    assert torch.equal(got, forced)
    y_r, _, _ = ref.moe(lp, x, HF, held=HELD, forced=forced)
    _close(y, y_r)
    assert (choice[:, 2] - choice[:, 5]).abs().max() < 1e-5


@pytest.mark.parametrize("ranks", [2, 4])
def test_the_held_shares_of_all_ranks_sum_to_the_uncut_layer(ranks):
    torch.manual_seed(5)
    cfg_all = kimi.from_hf_config(dict(HF, num_experts=16))
    assert cfg_all.experts_held is None
    lp = t3.init(L.Init(1, "cpu"), T3Config(llama=cfg_all))["llama"]["layers"][1]
    x = torch.randn(40, CFG.hidden_size)
    whole, ids_whole = dsv2.moe(lp, x, cfg_all, torch.float32)
    want, ids_r, _ = ref.moe(lp, x, HF)
    _close(whole, want)
    shared = dsv2._swiglu(lp["shared"], x, torch.float32)
    per = 16 // ranks
    total = shared.clone()
    for r in range(ranks):
        held = (r * per, (r + 1) * per)
        share = dict(lp, experts={k: {"w": v["w"][held[0]:held[1]]}
                                  for k, v in lp["experts"].items()})
        cfg_r = kimi.from_hf_config(HF).__class__(**{**cfg_all.__dict__, "experts_held": held})
        y, ids = dsv2.moe(share, x, cfg_r, torch.float32)
        assert torch.equal(ids, ids_whole)
        ref_y, _, _ = ref.moe(share, x, HF, held=held)
        _close(y, ref_y)
        total += y - shared
    _close(total, want)


def _rows(q, k, v, g, beta, s0, skip):
    """The delta rule written out one row, head and position at a time."""
    b, t, h, _ = q.shape
    o = torch.zeros(v.shape)
    s = s0.clone()
    for r in range(b):
        for hh in range(h):
            st = s[r, hh]
            for i in range(int(skip[r]), t):
                st = torch.diag(torch.exp(g[r, i, hh])) @ st
                kk = k[r, i, hh]
                st = st + beta[r, i, hh] * torch.outer(kk, v[r, i, hh] - st.T @ kk)
                o[r, i, hh] = st.T @ q[r, i, hh]
            s[r, hh] = st
    return o, s


@pytest.mark.parametrize("t,read", [(1, True), (7, True), (9, False)],
                         ids=["decode", "block", "prefill"])
def test_the_plain_k9_equals_the_delta_rule_row_by_row(t, read):
    g_ = torch.Generator().manual_seed(6)
    b, h, dk, dv = 3, 2, 8, 12
    q = F.normalize(torch.randn(b, t, h, dk, generator=g_), dim=-1) / dk ** 0.5
    k = F.normalize(torch.randn(b, t, h, dk, generator=g_), dim=-1)
    v = torch.randn(b, t, h, dv, generator=g_)
    g = -torch.rand(b, t, h, dk, generator=g_) * 2
    beta = torch.rand(b, t, h, generator=g_)
    s0 = torch.randn(b, h, dk, dv, generator=g_)
    skip = torch.tensor([0, min(2, t - 1), t], dtype=torch.int32) if t > 1 else None
    state = s0.clone()
    o = kda.kda_recurrent(q, k, v, g, beta, state, skip, read_state=read)
    want_o, want_s = _rows(q, k, v, g, beta, s0 if read else torch.zeros_like(s0),
                           skip if skip is not None else torch.zeros(b, dtype=torch.int32))
    torch.testing.assert_close(o, want_o, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(state, want_s, rtol=1e-5, atol=1e-5)
    if skip is not None:
        assert o[2].abs().max() == 0 and o[1, :2].abs().max() == 0


def test_the_device_counters_count_k9s_calls_tokens_and_states(params):
    torch.manual_seed(8)
    x = torch.randn(2, 30, CFG.hidden_size)
    pos = torch.arange(30)[None].expand(2, 30)
    mask = (torch.arange(40)[None] <= torch.arange(30)[:, None]) & (torch.arange(40)[None] >= 5)
    profiling.reset()
    cache = kimi.init_cache(CFG, 2, 40, torch.float32, "cpu", route=True)
    kimi.forward(params["llama"], x, pos, mask[None], cache=cache, cache_pos=0, cfg=CFG)
    assert not any(n.startswith(("kda.", "moe.")) for n in profiling.totals()["counters"])
    profiling.enable()
    try:
        kimi.forward(params["llama"], x, pos, mask[None], cache=cache, cache_pos=0, cfg=CFG)
        kimi.forward(params["llama"], x[:, :1], pos[:, :1], cache=cache,
                     cache_pos=torch.tensor([30]), cfg=CFG)
        got = profiling.totals()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    n_kda, heads = 2, CFG.kda_heads
    assert got["kda.calls"] == 2 * n_kda
    assert got["kda.tokens"] == n_kda * (2 * 25 + 2)
    assert got["kda.states_read"] == n_kda * 2 * heads
    assert got["kda.states_written"] == 2 * n_kda * 2 * heads
    rec = cache.route[:, :30].long()
    held = [((rec[j] < HELD[1]).sum()) for j in range(CFG.moe_layers)]
    assert got["moe.calls"] == 2 * CFG.moe_layers
    assert got["moe.assignments"] - sum(int(n) for n in held) == sum(
        int((cache.route[j, 30] < HELD[1]).sum()) for j in range(CFG.moe_layers))


# -- DeepSeek-V2's route and moe as they were before the held share ------------

def _route_before(lp, x, cfg):
    logits = x.float() @ lp["router"]["w"].float()
    w, ids = torch.topk(torch.softmax(logits, dim=-1), cfg.num_experts_per_tok, dim=-1)
    return ids, w * cfg.routed_scaling_factor


def _moe_before(lp, x, cfg, dtype, ids=None):
    n, k = x.shape[0], cfg.num_experts_per_tok
    if ids is None:
        ids, w = _route_before(lp, x, cfg)
    else:
        probs = torch.softmax(x.float() @ lp["router"]["w"].float(), dim=-1)
        w = probs.gather(1, ids) * cfg.routed_scaling_factor
    order, dest, offsets, counts = dsv2.sort_by_expert(ids, cfg.n_routed_experts)
    xs = x[torch.div(order, k, rounding_mode="floor")].to(dtype).contiguous()
    ex = lp["experts"]
    from chatterbox_embed_tpu_torch.kernels import moe_experts
    ys = moe_experts.grouped_swiglu(xs, offsets, ex["gate"]["w"], ex["up"]["w"], ex["down"]["w"])
    y = (ys[dest].view(n, k, -1) * w[..., None]).sum(1).to(dtype)
    return y + dsv2._swiglu(lp["shared"], x, dtype), ids


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_deepseek_v2s_route_and_moe_are_todays_bit_for_bit(dtype):
    c = dsv2.DeepseekV2Config(hidden_size=64, num_layers=2, num_heads=4, kv_lora_rank=32,
                              qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                              intermediate_size=96, moe_intermediate_size=32,
                              n_routed_experts=8, num_experts_per_tok=2)
    lp = dsv2.init(L.Init(3, "cpu"), c)["layers"][1]
    lp = {k: ({kk: {"w": vv["w"].to(dtype)} for kk, vv in v.items()} if k == "experts" else v)
          for k, v in lp.items()}
    x = torch.randn(30, 64, generator=torch.Generator().manual_seed(7)).to(dtype)
    for got, want in zip(dsv2.route(lp, x, c), _route_before(lp, x, c)):
        assert torch.equal(got, want)
    forced = torch.randint(0, 8, (30, 2), generator=torch.Generator().manual_seed(8))
    for ids in (None, forced):
        for got, want in zip(dsv2.moe(lp, x, c, dtype, ids=ids),
                             _moe_before(lp, x, c, dtype, ids=ids)):
            assert torch.equal(got, want)


# -- what the backbone does not run --------------------------------------------

@pytest.mark.parametrize("feature", sorted(backbone.FEATURES))
def test_each_unsupported_feature_raises_through_the_check(feature):
    assert backbone.of(CFG) is kimi
    with pytest.raises(NotImplementedError, match=f"^{re.escape(backbone.FEATURES[feature])} "
                                                  "is not ported for the Kimi-Linear backbone"):
        backbone.check(CFG, **{feature: True})
    backbone.check(CFG, **{feature: False})


def test_the_int8_engine_and_the_mesh_raise(params):
    for kw in (dict(kv_int8=True), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="Kimi-Linear backbone"):
            t3_engine.ContinuousDecoder(params, T3C, slots=2, text_bucket=32, max_new_tokens=20,
                                        block=8, device="cpu", **kw)


def test_the_serving_build_asks_for_k7_and_k9(monkeypatch):
    built, loaded = [], []
    monkeypatch.setattr(_build, "build_all", lambda sources: built.append(list(sources)))
    monkeypatch.setattr(_build, "load", lambda *args: loaded.append(args))
    tts._build_serving_kernels(kimi.SERVING_KERNELS)
    table = kernels.table()
    assert table["kda_recurrent"].module is kda
    assert kda.SOURCE in built[0] and table["moe_experts"].module.SOURCE in built[0]
    assert (kda.SOURCE, "cbx_kda_recurrent", kda._ARGTYPES) in loaded
