"""The port's fused T3 decode step (kernels/fused_decode.py, K4) against the
JAX package's Pallas kernel in interpret mode (CHATTERBOX_PALLAS=1, as
tests/test_fused_decode.py runs it), at that file's CFG, fp32.

- stack_for_fused: the port's wall equals the JAX wall segment for segment,
  the down segment after the port's stated transpose;
- the plain version against the JAX step: 2e-5 (the JAX file's own bound
  against its XLA step; the two differ in summation order only), 5e-5 over
  a 3-step chain;
- t3.generate with CHATTERBOX_FUSED_STEP=1: tokens equal to the JAX
  package's fused generate and to the port's default path;
- the gate: plan's rejections, ragged rows and the utterance cap.
The CUDA kernel itself is checked against the plain version on the card by
chip_smoke.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import LlamaConfig, T3Config
from chatterbox_embed_tpu.kernels import fused_decode as jfd
from chatterbox_embed_tpu.models import llama as jllama
from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu_torch.kernels import fused_decode as tfd
from chatterbox_embed_tpu_torch.models import llama as tllama
from chatterbox_embed_tpu_torch.models import t3 as tt3
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)
CFG = LlamaConfig(hidden_size=128, intermediate_size=256, num_layers=3,
                  num_heads=2, num_kv_heads=2, head_dim=64)
TCFG = T3Config(llama=CFG, text_tokens_dict_size=50, speech_tokens_dict_size=40,
                start_speech_token=36, stop_speech_token=37, max_text_tokens=64,
                max_speech_tokens=128, speaker_embed_size=16, speech_cond_prompt_len=6)


def _prefill(params, b, p_len, pad, total, rng):
    """tests/test_fused_decode.py:_prefill: a JAX cache filled by prefill."""
    ctx = jnp.asarray(rng.standard_normal((b, p_len, CFG.hidden_size)), jnp.float32)
    idx = jnp.arange(p_len)
    kidx = jnp.arange(total)
    mask = ((kidx[None, :] <= idx[:, None]) & (kidx[None, :] >= pad))[None]
    pos = jnp.broadcast_to(jnp.maximum(idx - pad, 0)[None], (b, p_len))
    cache = jllama.init_cache(CFG, b, total, jnp.float32)
    _, cache = jllama.forward(params, ctx, pos, mask, cache=cache, cache_pos=0, cfg=CFG)
    return cache


def _models(seed):
    jp = jllama.init(jax.random.PRNGKey(seed), CFG)
    tp = port_params(tllama.init, CFG, jp, "llama")
    return jp, tp, jfd.stack_for_fused(jp, CFG, jnp.float32), \
        tfd.stack_for_fused(tp, CFG, torch.float32)


def test_stack_for_fused_matches_jax_wall():
    jp, _, jf, tf = _models(0)
    d, qo, inter = CFG.hidden_size, CFG.num_heads * CFG.head_dim, CFG.intermediate_size
    jw, tw = np.asarray(jf["wall"]), tf["wall"].numpy()
    assert tw.shape == jw.shape == (3, 3 * qo + d + 3 * inter, d)
    dn = 3 * qo + d + 2 * inter
    np.testing.assert_array_equal(tw[:, :dn], jw[:, :dn])
    # down: the port stores down^T (d, I) flat over the segment's I rows
    np.testing.assert_array_equal(tw[:, dn:].reshape(3, d, inter).transpose(0, 2, 1), jw[:, dn:])
    for name in ("ln1", "ln2", "fnorm"):
        np.testing.assert_array_equal(tf[name].numpy(), np.asarray(jf[name]))
    np.testing.assert_array_equal(tw[1, dn:].reshape(d, inter),
                                  np.asarray(jp["layers"][1]["down"]["w"]).T)


@pytest.mark.parametrize("pad", [0, 7])
def test_reference_matches_jax_fused_step(rng, monkeypatch, pad):
    monkeypatch.setenv("CHATTERBOX_PALLAS", "1")
    b, total, p_len = 2, 256, 40
    jp, _, jf, tf = _models(0)
    cache = _prefill(jp, b, p_len, pad, total, rng)
    x = rng.standard_normal((b, CFG.hidden_size)).astype(np.float32)
    jh, jk, jv = jfd.fused_decode_step(jf, jnp.asarray(x), cache.k, cache.v, jnp.int32(p_len),
                                       jnp.int32(pad), CFG, dtype=jnp.float32)
    ck, cv = t(cache.k), t(cache.v)
    launches = tfd.fused_decode_step.launches
    h, k2, v2 = tfd.fused_decode_step(tf, t(x), ck, cv, p_len, pad, CFG, torch.float32)
    assert tfd.fused_decode_step.launches == launches, "CPU path counted a launch"
    assert k2 is ck and v2 is cv                      # written in place
    tol = dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **tol)
    np.testing.assert_allclose(k2.numpy(), np.asarray(jk), **tol)
    np.testing.assert_allclose(v2.numpy(), np.asarray(jv), **tol)


def test_reference_chain_matches_jax(rng, monkeypatch):
    """Three steps: each consumes the rows the previous one wrote."""
    monkeypatch.setenv("CHATTERBOX_PALLAS", "1")
    b, total, p_len, pad = 2, 256, 21, 3
    jp, _, jf, tf = _models(1)
    cache = _prefill(jp, b, p_len, pad, total, rng)
    jk, jv = cache.k, cache.v
    ck, cv = t(cache.k), t(cache.v)
    for step in range(3):
        x = rng.standard_normal((b, CFG.hidden_size)).astype(np.float32)
        jh, jk, jv = jfd.fused_decode_step(jf, jnp.asarray(x), jk, jv, jnp.int32(p_len + step),
                                           jnp.int32(pad), CFG, dtype=jnp.float32)
        h, ck, cv = tfd.fused_decode_step_reference(tf, t(x), ck, cv, p_len + step, pad, CFG,
                                                    torch.float32)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=5e-5, rtol=5e-5,
                                   err_msg=f"step {step}")
    np.testing.assert_allclose(ck.numpy(), np.asarray(jk), atol=5e-5, rtol=5e-5)


def test_reference_equals_llama_decode_step(rng):
    """Within the port: the fused plain version equals one llama.forward
    decode step (insert-first through K1's plain version)."""
    b, total, p_len, pad = 2, 256, 30, 5
    jp, tp, _, tf = _models(2)
    cache = _prefill(jp, b, p_len, pad, total, rng)
    x = t(rng.standard_normal((b, CFG.hidden_size)).astype(np.float32))
    c1 = tllama.KVCache(t(cache.k), t(cache.v))
    c2 = tllama.KVCache(t(cache.k), t(cache.v))
    pos_id = torch.full((b, 1), p_len - pad)
    ref, _ = tllama.forward(tp, x[:, None], pos_id, cache=c1, cache_pos=p_len, cfg=CFG,
                            flash_start=pad)
    h, _, _ = tfd.fused_decode_step_reference(tf, x, c2.k, c2.v, p_len, pad, CFG, torch.float32)
    np.testing.assert_allclose(h.numpy(), ref[:, 0].numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(c2.k.numpy(), c1.k.numpy(), atol=2e-5, rtol=2e-5)


def test_plan_rejections():
    """JAX's gate: qo == d and one kv head per head; the TPU's 128-lane rule
    is dropped (one row of a 64-wide model takes the fused step here)."""
    gqa = LlamaConfig(hidden_size=128, num_heads=4, num_kv_heads=2, head_dim=32)
    wide_heads = LlamaConfig(hidden_size=128, num_heads=4, num_kv_heads=4, head_dim=64)
    narrow = LlamaConfig(hidden_size=64, intermediate_size=128, num_heads=1, num_kv_heads=1,
                         head_dim=64)
    for cfg in (gqa, wide_heads):
        assert tfd.plan(cfg, 2) is None and jfd.plan(cfg, 2) is None
    assert tfd.plan(CFG, 2) is not None and jfd.plan(CFG, 2) is not None
    full = tfd.plan(LlamaConfig(), 2)
    assert full["s_total"] == 16384 and full["offsets"] == (0, 3072, 4096, 12288)
    assert jfd.plan(narrow, 1) is None and tfd.plan(narrow, 1) is not None


def test_off_cpu_raises_and_counts_nothing():
    _, _, _, tf = _models(0)
    meta = {k: v.to("meta") for k, v in tf.items()}
    x = torch.empty((2, 128), device="meta")
    ck = torch.empty((3, 256, 2, 2, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.fused_decode_step(meta, x, ck, ck.clone(), 10, 0, CFG, torch.float32)
    assert tfd.fused_decode_step.launches == 0


@pytest.fixture(scope="module")
def t3_models():
    jp = jt3.init(jax.random.PRNGKey(3), TCFG)
    return jp, port_params(tt3.init, TCFG, jp, "T3")


def _cond(seed=0):
    rng = np.random.default_rng(seed)
    spk = rng.standard_normal((1, 16)).astype(np.float32)
    prompt = rng.integers(0, 36, (1, 6)).astype(np.int32)
    text = np.concatenate([[5], rng.integers(1, 50, 9), [0]])[None].astype(np.int32)
    return (jt3.T3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5),
            tt3.T3Cond(t(spk), t(prompt), 0.5), text)


def test_generate_fused_tokens_equal_jax(t3_models, monkeypatch):
    jp, tp = t3_models
    jc, tc, text = _cond()
    kw = dict(max_new_tokens=12, temperature=0.7, cfg_weight=0.4, seed=4, cfg=TCFG)
    monkeypatch.setenv("CHATTERBOX_PALLAS", "1")
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "1")
    ref = np.asarray(jt3.generate(jp, jc, text, **kw))
    assert jt3.LAST_GENERATION_INFO["use_fused"] is True
    info = {}
    out = tt3.generate(tp, tc, text, draws=JaxDraws(4), info=info, **kw, device="cpu")
    assert info["use_fused"] is True
    np.testing.assert_array_equal(out, ref)
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "0")
    info = {}
    plain = tt3.generate(tp, tc, text, draws=JaxDraws(4), info=info, **kw, device="cpu")
    assert info["use_fused"] is False
    np.testing.assert_array_equal(plain, out)
    assert info["decode_steps"] >= len(out)


def test_fused_gate_ragged_rows_and_utterance_cap(t3_models, monkeypatch):
    _, tp = t3_models
    _, tc, text = _cond(1)
    two = np.concatenate([text, text])
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "1")
    kw = dict(cfg_weight=0.5, max_new_tokens=8, cfg=TCFG)
    _, info = tt3.start_generation(tp, tc, text, **kw, device="cpu")
    assert info["use_fused"] is True and info["fused"] is not None
    # above FUSED_STEP_MAX_UTTERANCES (1 by default)
    _, info = tt3.start_generation(tp, tc, two, **kw, device="cpu")
    assert info["use_fused"] is False and info["fused"] is None
    monkeypatch.setattr(tt3, "FUSED_STEP_MAX_UTTERANCES", 2)
    _, info = tt3.start_generation(tp, tc, two, text_lens=np.array([11, 11]), **kw, device="cpu")
    assert info["use_fused"] is True
    # ragged rows need per-row key holes: the fused step is off
    two[1, 8:] = 0
    _, info = tt3.start_generation(tp, tc, two, text_lens=np.array([11, 8]), **kw, device="cpu")
    assert info["use_fused"] is False and info["hole"] is not None
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "0")
    _, info = tt3.start_generation(tp, tc, text, **kw, device="cpu")
    assert info["use_fused"] is False


def test_fused_batch_of_two_equals_default(t3_models, monkeypatch):
    """Two unragged utterances (four CFG rows) through the fused branch give
    the default path's tokens."""
    _, tp = t3_models
    _, tc, text = _cond(2)
    rows = np.concatenate([text, text[:, ::-1].copy()])
    kw = dict(max_new_tokens=10, cfg_weight=0.5, temperature=0.8, seed=1,
              text_lens=np.array([11, 11]), cfg=TCFG)
    plain = tt3.generate_batch(tp, tc, rows, **kw, device="cpu")
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "1")
    monkeypatch.setattr(tt3, "FUSED_STEP_MAX_UTTERANCES", 2)
    fused = tt3.generate_batch(tp, tc, rows, **kw, device="cpu")
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a, b)
