"""The port's alignment guard (models/t3.py AlignState, alignment_flags and
the EOS surgery; models/llama.py's spy layer) against the JAX package's,
fp32 at the tiny T3 of tests/test_alignment_wired.py:

- the force / suppress flags on hand-made ring states, against the JAX
  package's decode_block math (replicated in jnp, as its own test does);
- the spy layer's head-mean probability row and hidden state against the
  JAX package's llama.forward(collect_attn_layer=...) on the same cache,
  with and without the deferred insert: 1e-5 (summation order only);
- tokens under the guard equal to the JAX package's, for one utterance
  and for a ragged batch with per-row text lengths (EOS decisions
  included), with the JAX decode on its XLA path and through its flash
  kernel in interpret mode (CHATTERBOX_PALLAS=1), and with the deferred
  insert;
- the guard forces EOS on the random model; with it off the tokens are
  bit-unchanged; it turns the fused step off.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import LlamaConfig, T3Config
from chatterbox_embed_tpu.models import llama as jllama
from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu_torch.models import alignment as talign
from chatterbox_embed_tpu_torch.models import llama as tllama
from chatterbox_embed_tpu_torch.models import t3 as tt3
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)
TINY = T3Config(
    llama=LlamaConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=4, head_dim=16),
    text_tokens_dict_size=50, speech_tokens_dict_size=40,
    start_speech_token=36, stop_speech_token=37,
    max_text_tokens=64, max_speech_tokens=256,
    speaker_embed_size=16, speech_cond_prompt_len=6)
EOS = TINY.stop_speech_token
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def models():
    jp = jt3.init(jax.random.PRNGKey(0), TINY)
    return jp, port_params(tt3.init, TINY, jp, "T3")


def _voice(seed):
    rng = np.random.default_rng(seed)
    spk = rng.standard_normal((1, 16)).astype(np.float32)
    prompt = rng.integers(0, 36, (1, 6)).astype(np.int32)
    return (jt3.T3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5),
            tt3.T3Cond(t(spk), t(prompt), 0.5))


def _text(seed, lt=12):
    rng = np.random.default_rng(seed)
    text = rng.integers(1, 50, (1, lt)).astype(np.int32)
    text[:, 0], text[:, -1] = 5, 0
    return text


def _jax_flags(ring, complete, completed_at, i):
    """The JAX package's decode_block.alignment_flags (a closure there)."""
    st = jt3.AlignState(jnp.asarray(ring, jnp.int32), jnp.asarray(complete),
                        jnp.asarray(completed_at, jnp.int32))
    long_tail = st.complete & ((i - st.completed_at) > 15)
    back = st.ring[:, 1:] < st.ring[:, :-1] - 3
    force = long_tail | (jnp.sum(back, axis=1) >= 3)
    return np.asarray(force), np.asarray(~st.complete & ~force)


RINGS = [  # (ring, complete, completed_at, step)
    ([[0, 2, 4, 6, 8, 10]], [False], [0], 6),           # monotonic, incomplete
    ([[10, 2, 9, 1, 8, 0]], [False], [0], 6),           # repeated backward jumps
    ([[10, 10, 10, 10, 10, 10]], [True], [5], 26),      # long dwell after completion
    ([[4, 5, 6, 7, 8, 10]], [True], [25], 26),          # just completed
    ([[9, 5, 9, 5, 9, 9]], [True], [20], 36),           # two jumps only, dwell 16
    ([[0, 0, 0, 0, 0, 0], [12, 7, 3, 11, 6, 1]], [False, True], [0, 3], 19),
]


@pytest.mark.parametrize("ring,complete,completed_at,step", RINGS)
def test_alignment_flags_match_jax(ring, complete, completed_at, step):
    st = tt3.AlignState(torch.tensor(ring, dtype=torch.int32), torch.tensor(complete),
                        torch.tensor(completed_at, dtype=torch.int32))
    force, suppress = tt3.alignment_flags(st, step)
    jforce, jsuppress = _jax_flags(ring, complete, completed_at, step)
    np.testing.assert_array_equal(force.numpy(), jforce)
    np.testing.assert_array_equal(suppress.numpy(), jsuppress)
    # the surgery: a forced row samples EOS whatever the draw, a
    # suppressed row never does
    lg = torch.randn((len(ring), 40), generator=torch.Generator().manual_seed(step))
    out = tt3._align_logits(lg, st, step, EOS)
    neg = torch.tensor(-1e30)
    for r in range(len(ring)):
        if jforce[r]:
            assert int(out[r].argmax()) == EOS and float(out[r].max()) == 0.0
            assert bool((out[r][torch.arange(40) != EOS] == neg).all())
        elif jsuppress[r]:
            assert out[r, EOS] == neg
            assert torch.equal(out[r][torch.arange(40) != EOS], lg[r][torch.arange(40) != EOS])
        else:
            assert torch.equal(out[r], lg[r])


def test_alignment_layer_constant():
    assert talign.ALIGNMENT_LAYER == 9
    from chatterbox_embed_tpu.models import alignment as jalign
    assert jalign.ALIGNMENT_LAYER == talign.ALIGNMENT_LAYER


@pytest.mark.parametrize("defer", ["0", "1"])
@pytest.mark.parametrize("ragged", [False, True])
def test_spy_row_matches_jax(models, monkeypatch, defer, ragged):
    """One decode step after a prefill: the port's spy layer (plain
    attention) against the JAX package's XLA spy (`_spy_row`), on the same
    cache; a ragged row's hole is the JAX package's key_valid mask."""
    jp, tp = models
    cfg = TINY.llama
    rng = np.random.default_rng(7)
    b, total, p_len, start = 2, 64, 20, 3
    x = rng.standard_normal((b, p_len + 1, cfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.maximum(np.arange(p_len + 1) - start, 0), (b, p_len + 1))
    kidx = np.arange(total)
    valid = (kidx[None, :] <= np.arange(p_len)[:, None]) & (kidx >= start)
    key_valid = np.ones((b, total), bool)
    hole = None
    if ragged:
        key_valid[1, 9:14] = False
        hole = torch.tensor([[0, 0], [9, 14]], dtype=torch.int32)
    pre_mask = valid[None] & key_valid[:, None, :]
    monkeypatch.setenv("CHATTERBOX_DEFER_KV", defer)
    jcache = jllama.init_cache(cfg, b, total)
    _, jcache = jllama.forward(jp["llama"], jnp.asarray(x[:, :p_len]),
                               jnp.asarray(pos[:, :p_len]), jnp.asarray(pre_mask),
                               cache=jcache, cache_pos=0, cfg=cfg)
    step_mask = ((kidx <= p_len) & (kidx >= start))[None, None, :] & key_valid[:, None, :]
    jh, _, jrow = jllama.forward(jp["llama"], jnp.asarray(x[:, p_len:]),
                                 jnp.asarray(pos[:, p_len:]), jnp.asarray(step_mask),
                                 cache=jcache, cache_pos=p_len, cfg=cfg,
                                 collect_attn_layer=1)
    cache = tllama.init_cache(cfg, b, total, device="cpu")
    _, cache = tllama.forward(tp["llama"], t(x[:, :p_len]), t(pos[:, :p_len]).long(),
                              t(pre_mask), cache=cache, cache_pos=0, cfg=cfg)
    h, cache, row = tllama.forward(tp["llama"], t(x[:, p_len:]), t(pos[:, p_len:]).long(),
                                   cache=cache, cache_pos=p_len, cfg=cfg, flash_start=start,
                                   flash_hole=hole, collect_attn_layer=1)
    np.testing.assert_allclose(row.numpy(), np.asarray(jrow), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(row.sum(-1).numpy(), np.ones(b), atol=1e-5)
    assert float(row[:, :start].abs().max()) == 0.0 and float(row[:, p_len + 1:].abs().max()) == 0.0
    if ragged:
        assert float(row[1, 9:14].abs().max()) == 0.0


def test_spy_layer_needs_a_decode_step(models):
    _, tp = models
    cfg = TINY.llama
    x = torch.zeros((1, 3, cfg.hidden_size))
    with pytest.raises(ValueError, match="single-token decode"):
        tllama.forward(tp["llama"], x, torch.zeros((1, 3), dtype=torch.long), cfg=cfg,
                       collect_attn_layer=1)


@pytest.mark.parametrize("pallas,defer,cfg_weight,seed", [
    ("0", "0", 0.5, 3), ("1", "0", 0.5, 3), ("1", "1", 0.5, 4), ("0", "0", 0.0, 0)])
def test_guard_tokens_equal_jax_one_utterance(models, monkeypatch, pallas, defer,
                                              cfg_weight, seed):
    jp, tp = models
    jc, tc = _voice(1)
    text = _text(2)
    monkeypatch.setenv("CHATTERBOX_PALLAS", pallas)
    monkeypatch.setenv("CHATTERBOX_DEFER_KV", defer)
    kw = dict(max_new_tokens=120, temperature=0.8, cfg_weight=cfg_weight, seed=seed,
              alignment=True, cfg=TINY)
    ref = np.asarray(jt3.generate(jp, jc, text, **kw))
    assert jt3.LAST_GENERATION_INFO["alignment"] is True
    info = {}
    out = tt3.generate(tp, tc, text, draws=JaxDraws(seed), info=info, **kw, device="cpu")
    np.testing.assert_array_equal(out, ref)
    assert info["align_layer"] == 1 and info["use_fused"] is False


@pytest.mark.parametrize("pallas", ["0", "1"])
def test_guard_tokens_equal_jax_ragged_batch(models, monkeypatch, pallas):
    """Three right-padded rows with their own text lengths: each row's
    completion test reads its own span, and every EOS decision agrees."""
    jp, tp = models
    jc, tc = _voice(3)
    rng = np.random.default_rng(4)
    lens = np.asarray([6, 11, 16], np.int32)
    rows = np.zeros((3, 16), np.int32)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(1, 50, (n,))
        rows[i, 0] = 5
    monkeypatch.setenv("CHATTERBOX_PALLAS", pallas)
    kw = dict(max_new_tokens=64, temperature=0.8, cfg_weight=0.5, seed=1, text_lens=lens,
              alignment=True, cfg=TINY)
    ref = jt3.generate_batch(jp, jc, rows, **kw)
    out = tt3.generate_batch(tp, tc, rows, make_draws=JaxDraws, **kw, device="cpu")
    assert len(out) == 3
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(a, np.asarray(r))
        assert a[-1] == EOS and len(a) < 64


def test_guard_forces_eos_on_random_model(models):
    """Random weights attend all over the text: the guard ends the decode
    with a forced EOS well before the cap, where the unguarded decode runs
    to it."""
    _, tp = models
    _, tc = _voice(5)
    kw = dict(max_new_tokens=200, cfg_weight=0.5, seed=3, cfg=TINY, device="cpu")
    out = tt3.generate(tp, tc, _text(6), alignment=True, **kw)
    assert out[-1] == EOS and len(out) < 200
    free = tt3.generate(tp, tc, _text(6), **kw)
    assert len(free) > len(out)


def test_guard_suppresses_early_eos(models):
    _, tp = models
    _, tc = _voice(8)
    out = tt3.generate(tp, tc, _text(9), max_new_tokens=64, cfg_weight=0.0, temperature=5.0,
                       seed=0, alignment=True, cfg=TINY, device="cpu")
    assert out[0] != EOS


def test_guard_off_is_bit_unchanged(models):
    """alignment=False is the default path: the same tokens, and every
    layer attends through K1 (no spy layer, no row)."""
    jp, tp = models
    jc, tc = _voice(10)
    text = _text(11)
    kw = dict(max_new_tokens=40, cfg_weight=0.5, temperature=0.8, seed=7, cfg=TINY)
    a = tt3.generate(tp, tc, text, draws=JaxDraws(7), **kw, device="cpu")
    info = {}
    b = tt3.generate(tp, tc, text, draws=JaxDraws(7), alignment=False, info=info, **kw,
                     device="cpu")
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, np.asarray(jt3.generate(jp, jc, text, **kw)))
    assert info["align_layer"] is None and info["text_start"] is None


def test_start_generation_alignment_turns_fused_off(models, monkeypatch):
    _, tp = models
    _, tc = _voice(12)
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "1")
    kw = dict(cfg_weight=0.5, max_new_tokens=10, cfg=TINY, device="cpu")
    _, info = tt3.start_generation(tp, tc, _text(13), **kw)
    assert info["use_fused"] is True
    _, info = tt3.start_generation(tp, tc, _text(13), alignment=True, **kw)
    assert info["use_fused"] is False and info["fused"] is None
    assert info["align_layer"] == min(talign.ALIGNMENT_LAYER, TINY.llama.num_layers - 1)
    assert info["text_start"] == info["pad"] + tt3.cond_width(tc, TINY)
    assert info["text_len"].tolist() == [12]
