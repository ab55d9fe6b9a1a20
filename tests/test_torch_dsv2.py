"""T3 with a DeepSeek-V2 backbone (models/deepseek_v2.py) against the plain
fp32 reference `tests/dsv2_reference.py`, on the CPU at a tiny size that
keeps every mechanism: 3 layers (1 dense, 2 MoE), 8 routed experts of
which 2 a token, 2 shared, latent 32, rope 8, nope 16, v 16, 4 heads, and
YaRN with an original length of 64 so that its ramp bites inside the
positions used.

- the teacher-forced forward, and prefill then the absorbed decode through
  the latent cache, match the reference's full forward (logits at every
  position, 1e-4 relative: fp32 against fp32, sums in another order);
- the MoE layer matches with the routing forced, near-ties planted;
- YaRN's frequencies, mscale and softmax scale match numbers by hand;
- the engine's step (EngineStep, one piece called as it is on the CPU) gives the
  eager step's tokens through ContinuousServer, and its routing record
  equals the reference's routing away from ties;
- the device counters equal a bincount of the record, and stay silent when
  profiling is off;
- every path the backbone does not run raises, through the one check
  (`backbone.check`), which names the feature asked for.
"""
import math
import re
from dataclasses import replace

import numpy as np
import pytest
import torch

import dsv2_reference as ref
import k7_routings
from chatterbox_embed_tpu_torch.conditionals import Conditionals
from chatterbox_embed_tpu_torch.config import (ChatterboxConfig, ConformerConfig,
                                               FlowDecoderConfig, HiFTConfig, LlamaConfig,
                                               S3GenConfig, S3TokenizerConfig, T3Config)
from chatterbox_embed_tpu_torch.kernels import moe_experts
from chatterbox_embed_tpu_torch.models import backbone
from chatterbox_embed_tpu_torch.models import deepseek_v2 as dsv2
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.models import t3, t3_engine
from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer
from chatterbox_embed_tpu_torch.serving.continuous import ContinuousServer
from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
from chatterbox_embed_tpu_torch.utils import profiling

torch.set_num_threads(2)

HF = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
      "num_key_value_heads": 4, "q_lora_rank": None, "kv_lora_rank": 32,
      "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
      "intermediate_size": 96, "moe_intermediate_size": 32, "n_routed_experts": 8,
      "n_shared_experts": 2, "num_experts_per_tok": 2, "first_k_dense_replace": 1,
      "moe_layer_freq": 1, "routed_scaling_factor": 1.0, "norm_topk_prob": False,
      "scoring_func": "softmax", "topk_method": "greedy", "n_group": 1, "topk_group": 1,
      "rms_norm_eps": 1e-6, "rope_theta": 10000, "max_position_embeddings": 163840,
      "hidden_act": "silu", "attention_bias": False,
      "rope_scaling": {"type": "yarn", "factor": 40, "original_max_position_embeddings": 64,
                       "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                       "mscale_all_dim": 0.707}}
CFG = dsv2.from_hf_config(HF)
T3C = T3Config(llama=CFG, max_text_tokens=64, max_speech_tokens=128, speech_cond_prompt_len=8)
TINY = ChatterboxConfig(
    t3=T3C,
    s3gen=S3GenConfig(
        flow=replace(S3GenConfig().flow,
                     encoder=ConformerConfig(input_size=32, output_size=32, attention_heads=4,
                                             linear_units=64, num_blocks=1, num_up_blocks=1),
                     decoder=FlowDecoderConfig(in_channels=32, out_channels=8, channels=16,
                                               attention_head_dim=8, num_heads=2, n_blocks=1,
                                               num_mid_blocks=1, time_embed_dim=64),
                     input_size=32, output_size=8),
        hift=HiFTConfig(in_channels=8, base_channels=32, f0_cond_channels=16),
        tokenizer=S3TokenizerConfig(n_state=64, n_heads=4, n_layers=1), mel_num=8))
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


def test_yarn_frequencies_and_scales_by_hand():
    # dim 8, base 1e4: correction dims of 32 and 1 rotations over 64 positions
    dim, base, orig = 8, 10000.0, 64
    low_d = dim * math.log(orig / (32 * 2 * math.pi)) / (2 * math.log(base))
    high_d = dim * math.log(orig / (1 * 2 * math.pi)) / (2 * math.log(base))
    low, high = max(math.floor(low_d), 0), min(math.ceil(high_d), dim - 1)
    assert (low, high) == (0, 2)          # index 0 kept, 1 half way, 2 and 3 interpolated
    want = []
    for j in range(dim // 2):
        f = base ** (-2 * j / dim)
        keep = 1 - min(max((j - low) / (high - low), 0.0), 1.0)
        want.append(f / 40 * (1 - keep) + f * keep)
    np.testing.assert_allclose(dsv2.yarn_inv_freq(CFG), want, rtol=1e-6)
    np.testing.assert_allclose(ref.yarn_inv_freq(HF).numpy(), want, rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert m == pytest.approx(1.26081, abs=1e-5)
    assert dsv2.softmax_scale(dsv2.DeepseekV2Config()) == pytest.approx(192 ** -0.5 * m * m)
    assert dsv2.softmax_scale(CFG) == pytest.approx(ref.softmax_scale(HF))
    assert dsv2.rope_scale(CFG) == 1.0


def test_teacher_forced_forward_matches_the_reference(params):
    rng = np.random.default_rng(1)
    cond = _cond(rng)
    text = torch.tensor(rng.integers(1, 704, (2, 10)), dtype=torch.int32)
    speech = torch.tensor(rng.integers(0, 6561, (2, 12)), dtype=torch.int32)
    lens_t, lens_s = torch.tensor([10, 7]), torch.tensor([12, 9])
    tl, sl = t3.forward(params, cond, text, lens_t, speech, lens_s, cfg=T3C)
    x, _, mask, widths = t3._train_context(params, cond, text, lens_t, speech, lens_s, T3C)
    h, _ = ref.backbone(params["llama"], x, HF, mask=mask)
    lc, lt, ls = widths
    _close(tl, h[:, lc - 1:lc - 1 + lt] @ params["text_head"]["w"])
    _close(sl, h[:, lc + lt - 1:lc + lt - 1 + ls] @ params["speech_head"]["w"])


def test_prefill_then_absorbed_decode_matches_the_full_forward(params):
    torch.manual_seed(2)
    b, t_all, t_pre = 2, 40, 24
    x = torch.randn(b, t_all, CFG.hidden_size)
    want, _ = ref.backbone(params["llama"], x, HF)
    cache = dsv2.init_cache(CFG, b, 64, torch.float32, "cpu")
    pos = torch.arange(t_all)[None].expand(b, t_all)
    got = [dsv2.forward(params["llama"], x[:, :t_pre], pos[:, :t_pre], cache=cache,
                        cache_pos=0, cfg=CFG)[0]]
    for i in range(t_pre, t_all):        # one token a step, absorbed
        got.append(dsv2.forward(params["llama"], x[:, i:i + 1], pos[:, i:i + 1], cache=cache,
                                cache_pos=i, cfg=CFG)[0])
    head = params["speech_head"]["w"]
    _close(torch.cat(got, 1) @ head, want @ head)


def test_moe_matches_with_routing_forced_and_near_ties(params):
    torch.manual_seed(3)
    lp = dict(params["llama"]["layers"][1])
    w = lp["router"]["w"].clone()
    w[:, 5] = w[:, 2] + 1e-7 * torch.randn(w.shape[0])     # experts 2 and 5 tie to 1e-7
    lp["router"] = {"w": w}
    x = torch.randn(48, CFG.hidden_size)
    _, ids_ref, probs = ref.moe(lp, x, HF)
    # force the other member of each tied pair wherever the reference took one
    forced = ids_ref.clone()
    forced[ids_ref == 2], forced[ids_ref == 5] = 5, 2
    forced = torch.where(forced[:, :1] == forced[:, 1:], ids_ref, forced)
    y, ids = dsv2.moe(lp, x, CFG, torch.float32, ids=forced)
    assert torch.equal(ids, forced)
    y_ref, _, _ = ref.moe(lp, x, HF, forced=forced)
    _close(y, y_ref)
    assert (probs[:, 2] - probs[:, 5]).abs().max() < 1e-5


def test_sort_by_expert_and_the_plain_grouped_swiglu():
    torch.manual_seed(4)
    ids = torch.randint(0, 8, (20, 2))
    order, dest, offsets, counts = dsv2.sort_by_expert(ids, 8)
    flat = ids.reshape(-1)
    assert torch.equal(order[dest], torch.arange(40))
    assert torch.equal(torch.bincount(flat, minlength=8), counts)
    assert offsets.tolist() == [0] + torch.cumsum(counts, 0).tolist()
    assert torch.equal(flat[order], torch.sort(flat).values)
    for e in range(8):                                  # stable: each expert's rows in order
        mine = order[offsets[e]:offsets[e + 1]]
        assert torch.equal(mine, torch.sort(mine).values)
    x = torch.randn(40, 16)
    wg, wu, wd = torch.randn(8, 16, 24), torch.randn(8, 16, 24), torch.randn(8, 24, 16)
    y = moe_experts.grouped_swiglu(x[order], offsets, wg, wu, wd)
    for n, a in enumerate(order.tolist()):
        e = int(flat[a])
        h = torch.nn.functional.silu(x[a] @ wg[e]) * (x[a] @ wu[e])
        torch.testing.assert_close(y[n], h @ wd[e], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", k7_routings.CASES)
def test_the_plain_grouped_swiglu_row_by_row_at_the_kernels_routings(case):
    # the routings that reach each width and edge of K7 (k7_routings.py) at
    # 64 experts, D 32, F 48, fp32: the plain loop against y written out
    # row by row, each row by the expert whose offsets hold it (1e-4: fp32
    # sums in another order)
    g = torch.Generator().manual_seed(5)
    c = k7_routings.counts(case)
    offsets = k7_routings.offsets(c)
    e, d, f = k7_routings.EXPERTS, 32, 48
    x = torch.randn(sum(c), d, generator=g)
    wg = torch.randn(e, d, f, generator=g) / math.sqrt(d)
    wu = torch.randn(e, d, f, generator=g) / math.sqrt(d)
    wd = torch.randn(e, f, d, generator=g) / math.sqrt(f)
    y = moe_experts.grouped_swiglu_reference(x, offsets, wg, wu, wd)
    owner = [k for k, n in enumerate(c) for _ in range(n)]
    assert y.shape == (len(owner), d)
    for r, k in enumerate(owner):
        a = x[r] @ wg[k]
        h = a / (1 + torch.exp(-a)) * (x[r] @ wu[k])
        torch.testing.assert_close(y[r], h @ wd[k], rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def tts():
    return ChatterboxTTS.from_random(seed=0, config=TINY, device="cpu")


def _voice(seed):
    rng = np.random.default_rng(seed)
    gen = dict(prompt_token=rng.integers(0, 6561, (1, 8)).astype(np.int64),
               prompt_token_len=np.array([8]),
               prompt_feat=rng.standard_normal((1, 16, 8)).astype(np.float32),
               prompt_feat_len=None, embedding=rng.standard_normal((1, 192)).astype(np.float32))
    return Conditionals(_cond(rng), gen)


def _serve(tts, eager: bool, route_record=False):
    srv = ContinuousServer(tts, slots=2, text_bucket=32, max_new_tokens=30, block=8,
                           vocode_batch=2, route_record=route_record)
    assert srv.decoder.pieces.whole
    if eager:
        srv.decoder.pieces = None         # the eager step, engine_decode_block
    voices = [_voice(5), _voice(6)]
    rids = [srv.submit(text, voices[k % 2], seed=40 + k, max_new_tokens=12 + 4 * k, **SAMPLING)
            for k, text in enumerate(["Hello there.", "A second one, longer.", "Third.",
                                      "And a fourth line of text."])]
    wavs = srv.drain()
    return srv, [wavs[r] for r in rids]


def test_server_drains_with_the_eager_steps_tokens(tts):
    _, whole = _serve(tts, eager=False)
    _, eager = _serve(tts, eager=True)
    assert all(w.size > 0 for w in whole)
    for a, b in zip(whole, eager):
        np.testing.assert_array_equal(a, b)


def _engine_run(params, route_record=True):
    rng = np.random.default_rng(7)
    dec = t3_engine.ContinuousDecoder(params, T3C, slots=2, text_bucket=32, max_new_tokens=40,
                                      block=8, device="cpu", route_record=route_record)
    reqs = [(_text(rng, int(rng.integers(5, 20))), _cond(rng), 60 + k, int(rng.integers(10, 30)))
            for k in range(4)]
    rids = [dec.submit(tx, c, seed=s, max_new_tokens=m, **SAMPLING) for tx, c, s, m in reqs]
    out = dec.drain()
    return dec, reqs, [(r, out[r]) for r in rids]


def test_routing_record_matches_the_references_routing(params):
    dec, reqs, done = _engine_run(params)
    k = CFG.num_experts_per_tok
    checked = 0
    for (text, cond, _, _), (rid, toks) in zip(reqs, done):
        rec = dec.routes[rid]                                 # (moe layers, positions, 2, k)
        tb = torch.from_numpy(text)
        ctx = t3._build_context(params, cond, tb, T3C, True, 0)             # (2, P, D)
        feed = torch.from_numpy(toks[:-1].astype(np.int64))
        emb = (L.embedding(params["speech_emb"], feed)
               + params["speech_pos_emb"]["w"][1:len(toks)])
        x = torch.cat([ctx, torch.stack([emb, emb])], dim=1)
        assert rec.shape == (CFG.moe_layers, x.shape[1], 2, k)
        _, routes = ref.backbone(params["llama"], x, HF)
        for j, (ids, probs) in enumerate(routes):
            top = probs.sort(-1, descending=True).values
            clear = (top[..., k - 1] - top[..., k]) > 1e-4            # away from a tie
            got = torch.from_numpy(rec[j].astype(np.int64)).transpose(0, 1).sort(-1).values
            want = ids.sort(-1).values
            assert torch.equal(got[clear], want[clear])
            checked += int(clear.sum())
    assert checked > 100


def test_device_counters_are_a_bincount_of_the_record(params):
    torch.manual_seed(8)
    x = torch.randn(2, 30, CFG.hidden_size)
    pos = torch.arange(30)[None].expand(2, 30)
    profiling.reset()
    cache = dsv2.init_cache(CFG, 2, 32, torch.float32, "cpu", route=True)
    dsv2.forward(params["llama"], x, pos, cache=cache, cache_pos=0, cfg=CFG)
    assert not any(n.startswith("moe.") for n in profiling.totals()["counters"])
    profiling.enable()
    try:
        cache = dsv2.init_cache(CFG, 2, 32, torch.float32, "cpu", route=True)
        dsv2.forward(params["llama"], x, pos, cache=cache, cache_pos=0, cfg=CFG)
        got = profiling.totals()["counters"]
    finally:
        profiling.disable()
        profiling.reset()
    rec = cache.route[:, :30].long()
    counts = [torch.bincount(rec[j].reshape(-1), minlength=CFG.n_routed_experts)
              for j in range(CFG.moe_layers)]
    assert got["moe.calls"] == CFG.moe_layers
    assert got["moe.assignments"] == CFG.moe_layers * 60 * CFG.num_experts_per_tok
    assert got["moe.experts_touched"] == sum(int((c > 0).sum()) for c in counts)
    assert got["moe.max_expert_rows"] == sum(int(c.max()) for c in counts)


def _int8_engine(params):
    t3_engine.ContinuousDecoder(params, T3C, slots=2, text_bucket=32, max_new_tokens=20,
                                block=8, device="cpu", kv_int8=True)


def _mesh_engine(params):
    t3_engine.ContinuousDecoder(params, T3C, slots=2, text_bucket=32, max_new_tokens=20,
                                block=8, device="cpu", mesh=object())


def _int8_weights(params):
    from chatterbox_embed_tpu_torch.utils.quantize import quantize_t3
    quantize_t3(params, T3C)


def _fused_step(params, monkeypatch=None):
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "1")
    t3.generate(params, _cond(np.random.default_rng(0)), _text(np.random.default_rng(0), 5),
                max_new_tokens=4, cfg_weight=0.3, cfg=T3C, device="cpu")


def _alignment(params):
    t3.generate(params, _cond(np.random.default_rng(0)), _text(np.random.default_rng(0), 5),
                max_new_tokens=4, cfg_weight=0.3, alignment=True, cfg=T3C, device="cpu")


def _first_chunk(params):
    from chatterbox_embed_tpu_torch import streaming
    streaming.first_chunk(params, None, _cond(np.random.default_rng(0)), np.zeros((1, 5)),
                          prompt_tokens=None, prompt_feat=None, embedding=None, cfg=TINY,
                          device="cpu")


def _training(params):
    from chatterbox_embed_tpu_torch.training.train_step import make_t3_train_step
    make_t3_train_step(cfg=T3C)


def _int8_cache(params, monkeypatch=None):
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    t3.generate(params, _cond(np.random.default_rng(0)), _text(np.random.default_rng(0), 5),
                max_new_tokens=4, cfg_weight=0.3, cfg=T3C, device="cpu")


@pytest.mark.parametrize("path", [_int8_engine, _int8_cache, _mesh_engine, _int8_weights,
                                  _fused_step, _alignment, _first_chunk, _training],
                         ids=lambda f: f.__name__.strip("_"))
def test_unsupported_paths_raise(params, path, monkeypatch):
    kw = {"monkeypatch": monkeypatch} if "monkeypatch" in path.__code__.co_varnames else {}
    with pytest.raises(NotImplementedError, match="DeepSeek-V2 backbone"):
        path(params, **kw)


@pytest.mark.parametrize("feature", sorted(backbone.FEATURES))
def test_the_backbone_check_refuses_each_feature_of_the_latent_backbone_alone(feature):
    with pytest.raises(NotImplementedError, match=f"^{re.escape(backbone.FEATURES[feature])} "
                                                  "is not ported for the DeepSeek-V2 backbone"):
        backbone.check(CFG, **{feature: True})
    backbone.check(CFG, **{feature: False})
    backbone.check(LlamaConfig(), **{feature: True})
    with pytest.raises(KeyError):
        backbone.check(CFG, **{feature + "_typo": True})


def test_the_mesh_refuses_the_latent_pipeline(tts):
    with pytest.raises(NotImplementedError, match="DeepSeek-V2 backbone"):
        tts.enable_mesh(1, device="cpu")


def test_lock_step_generate_runs_the_latent_backbone(params):
    rng = np.random.default_rng(9)
    toks = t3.generate(params, _cond(rng), _text(rng, 8), max_new_tokens=10, cfg_weight=0.3,
                       temperature=0.6, cfg=T3C, device="cpu", seed=1)
    assert 1 <= len(toks) <= 10
    assert t3.kv_bytes_per_token_row(T3C, torch.bfloat16) == 3 * 40 * 2
