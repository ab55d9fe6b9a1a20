"""The port's T3 (models/t3.py, ops/sampling.py) against the JAX package:
prefill logits of the CFG context, then sampled tokens from generate with
JAX's own Gumbel draws fed to the port. Tokens must be equal; logits agree
to 1e-4 (fp32, summation order only)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import LlamaConfig, T3Config
from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu.ops import sampling as jsampling
from chatterbox_embed_tpu_torch.models import t3 as tt3
from chatterbox_embed_tpu_torch.ops import sampling as tsampling
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)
TINY = T3Config(
    llama=LlamaConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=4, head_dim=16),
    text_tokens_dict_size=50, speech_tokens_dict_size=40,
    start_speech_token=36, stop_speech_token=37,
    max_text_tokens=64, max_speech_tokens=128,
    speaker_embed_size=16, speech_cond_prompt_len=6,
)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def models():
    jp = jt3.init(jax.random.PRNGKey(0), TINY)
    return jp, port_params(tt3.init, TINY, jp, "T3")


def _conds(seed=0):
    rng = np.random.default_rng(seed)
    spk = rng.standard_normal((1, 16)).astype(np.float32)
    prompt = rng.integers(0, 36, (1, 6)).astype(np.int32)
    text = np.concatenate([[255 % 50], rng.integers(1, 50, 11), [0]]).astype(np.int32)[None]
    jc = jt3.T3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5)
    tc = tt3.T3Cond(t(spk), t(prompt), 0.5)
    return jc, tc, text


def test_gumbel_argmax_is_jax_categorical():
    """The port samples argmax(logits + gumbel): that is what
    jax.random.categorical computes for the same key."""
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((1, 40)).astype(np.float32) * 3
    logits[0, ::7] = -np.inf
    draws = JaxDraws(0)
    for step in range(20):
        cat = jsampling.sample_token(jax.random.fold_in(draws.key, step), jnp.asarray(logits))
        mine = tsampling.sample_token(t(logits), draws.gumbel(step, logits.shape))
        assert int(cat[0]) == int(mine[0])


def test_process_logits_matches_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((1, 40)) * 4).astype(np.float32)
    counts = rng.integers(0, 2, (1, 40)).astype(np.int32)
    for use_top_p in (False, True):
        kw = dict(valid_size=36, eos_id=37, temperature=0.7, repetition_penalty_val=1.2,
                  min_p=0.05, top_p=0.8, use_top_p=use_top_p)
        ref = jsampling.process_logits(jnp.asarray(logits), jnp.asarray(counts), **kw)
        out = tsampling.process_logits(t(logits), t(counts), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


def test_cond_embeds_and_prefill_logits_match(models):
    jp, tp = models
    jc, tc, text = _conds()
    np.testing.assert_allclose(tt3.cond_embeds(tp, tc, TINY).numpy(),
                               np.asarray(jt3.cond_embeds(jp, jc, TINY)), **TOL)
    state, info = tt3.start_generation(tp, tc, text, cfg_weight=0.5, max_new_tokens=30,
                                       cfg=TINY, device="cpu")
    pad = info["pad"]
    tb = jnp.asarray(np.pad(text, ((0, 0), (pad, 0))))
    jstate = jt3._context_prefill(jp, jc, tb, None, jnp.int32(pad), TINY,
                                  info["cache_total"], True)
    np.testing.assert_allclose(state.logits.numpy(), np.asarray(jstate.logits), **TOL)
    np.testing.assert_allclose(state.cache.k.numpy(), np.asarray(jstate.cache.k), **TOL)
    assert info["cache_total"] % 256 == 0


@pytest.mark.parametrize("top_p,cfg_weight,pallas,stop", [
    (1.0, 0.5, "1", True), (0.9, 0.5, "0", True), (1.0, 0.0, "0", True),
    (1.0, 0.5, "1", False)])
def test_generate_tokens_equal_jax(models, monkeypatch, top_p, cfg_weight, pallas, stop):
    """CHATTERBOX_PALLAS=1 runs the JAX decode through its flash-decode
    kernel (interpret mode), as the TPU does at one utterance."""
    monkeypatch.setenv("CHATTERBOX_PALLAS", pallas)
    jp, tp = models
    jc, tc, text = _conds(1)
    kw = dict(max_new_tokens=40, temperature=0.8, cfg_weight=cfg_weight,
              repetition_penalty=1.2, min_p=0.05, top_p=top_p, seed=0,
              stop_on_eos=stop, cfg=TINY)
    ref = jt3.generate(jp, jc, text, **kw)
    assert jt3.LAST_GENERATION_INFO["use_flash"] == (pallas == "1")
    info = {}
    out = tt3.generate(tp, tc, text, draws=JaxDraws(0), info=info, **kw, device="cpu")
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert info["decode_steps"] >= len(out) > 0
    if not stop:
        assert len(out) == 40


def test_start_generation_rejects_out_of_range_requests(models):
    """Too many new tokens, more rows than the utterance fence, and more
    than one row through the single-utterance `generate` all raise."""
    _, tp = models
    _, tc, text = _conds()
    with pytest.raises(ValueError, match="speech positions"):
        tt3.start_generation(tp, tc, text, cfg_weight=0.5,
                             max_new_tokens=TINY.max_speech_seq_len, cfg=TINY, device="cpu")
    two = np.concatenate([text, text])
    with pytest.raises(ValueError, match="max_decode_utterances"):
        tt3.start_generation(tp, tc, two, cfg_weight=0.5, max_new_tokens=10, cfg=TINY,
                             free_bytes=1, device="cpu")
    with pytest.raises(ValueError, match="one utterance"):
        tt3.generate(tp, tc, two, cfg_weight=0.5, max_new_tokens=10, cfg=TINY, device="cpu")
