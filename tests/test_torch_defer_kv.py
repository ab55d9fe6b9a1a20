"""The deferred-insert decode (CHATTERBOX_DEFER_KV=1) of the port against the
JAX package, fp32:

- K1s's plain version (kernels/flash_decode.py: the stacked cache with a
  layer index, the current k/v row folded in) against the JAX kernel's
  deferred entry in interpret mode, with and without holes: 1e-5 (the two
  differ in summation order only);
- t3.generate and generate_batch under CHATTERBOX_DEFER_KV=1: tokens equal
  to the JAX package's defer run and to the port's default (insert-first)
  path. CHATTERBOX_PALLAS=1 runs the JAX decode through its flash kernel's
  deferred entry at up to 2 utterances, as on the TPU.
The CUDA kernel itself is checked on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import LlamaConfig, T3Config
from chatterbox_embed_tpu.kernels import flash_decode as jfd
from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu_torch.kernels import flash_decode as tfd
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.models import llama as tllama
from chatterbox_embed_tpu_torch.models import t3 as tt3
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
TINY = T3Config(
    llama=LlamaConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=4, head_dim=16),
    text_tokens_dict_size=50, speech_tokens_dict_size=40,
    start_speech_token=36, stop_speech_token=37,
    max_text_tokens=64, max_speech_tokens=128,
    speaker_embed_size=16, speech_cond_prompt_len=6,
)


def _stacked(rng, n_layers=3, lc=256, b=2, h=4, d=64):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((n_layers, lc, b, h, d)).astype(np.float32) for _ in range(2))
    kc, vc = (rng.standard_normal((b, h, d)).astype(np.float32) for _ in range(2))
    return q, k, v, kc, vc


@pytest.mark.parametrize("layer,start,pos,hole", [
    (0, 0, 0, None), (1, 0, 1, None), (2, 3, 40, None), (1, 10, 255, None),
    (2, 8, 200, [[0, 0], [30, 60]]), (0, 0, 100, [[20, 40], [50, 99]])])
def test_deferred_entry_matches_jax_kernel(rng, layer, start, pos, hole):
    q, k, v, kc, vc = _stacked(rng)
    jh = None if hole is None else jnp.asarray(hole, jnp.int32)
    ref = jfd.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
                               jnp.int32(start), hole=jh, interpret=True,
                               layer=jnp.int32(layer), k_cur=jnp.asarray(kc),
                               v_cur=jnp.asarray(vc))
    th = None if hole is None else torch.tensor(hole, dtype=torch.int32)
    before = (tfd.decode_attention.launches, tfd.decode_attention.launches_deferred)
    out = tfd.decode_attention(t(q), t(k), t(v), pos, start, th, layer=layer,
                               k_cur=t(kc), v_cur=t(vc))
    assert (tfd.decode_attention.launches,
            tfd.decode_attention.launches_deferred) == before, "CPU path counted a launch"
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_deferred_equals_insert_first(rng):
    """Folding the current row equals writing it at cache_pos first and
    attending [start, cache_pos]; the slot itself is never read."""
    q, k, v, kc, vc = _stacked(rng, n_layers=2, lc=128)
    k_ins, v_ins = k.copy(), v.copy()
    k_ins[1, 70], v_ins[1, 70] = kc, vc
    k[1, 70], v[1, 70] = 1e3, -1e3                    # garbage in the unread slot
    out = tfd.decode_attention_reference(t(q), t(k), t(v), 70, 4, layer=1, k_cur=t(kc),
                                         v_cur=t(vc))
    ins = tfd.decode_attention_reference(t(q), t(k_ins[1]), t(v_ins[1]), 70, 4)
    np.testing.assert_allclose(out.numpy(), ins.numpy(), **TOL)


def test_deferred_entry_argument_checks(rng):
    q, k, v, kc, vc = _stacked(rng)
    with pytest.raises(ValueError, match="both k_cur and v_cur"):
        tfd.decode_attention(t(q), t(k), t(v), 5, 0, layer=0, k_cur=t(kc))
    with pytest.raises(ValueError, match="needs `layer`"):
        tfd.decode_attention(t(q), t(k), t(v), 5, 0, k_cur=t(kc), v_cur=t(vc))


def test_llama_defer_step_equals_insert_first(rng, monkeypatch):
    """One decode step of llama.forward with the deferred insert: the same
    hidden state and the same cache as insert-first."""
    cfg = TINY.llama
    params = tllama.init(L.Init(3, device="cpu"), cfg)
    b, total, p_len = 2, 64, 20
    x = torch.randn((b, p_len + 1, cfg.hidden_size), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(p_len + 1)[None].expand(b, -1)
    caches = []
    for defer in ("0", "1"):
        monkeypatch.setenv("CHATTERBOX_DEFER_KV", defer)
        cache = tllama.init_cache(cfg, b, total, device="cpu")
        _, cache = tllama.forward(params, x[:, :p_len], pos[:, :p_len], cache=cache,
                                  cache_pos=0, cfg=cfg)
        h, cache = tllama.forward(params, x[:, p_len:], pos[:, p_len:], cache=cache,
                                  cache_pos=p_len, cfg=cfg)
        caches.append((h, cache))
    (h0, c0), (h1, c1) = caches
    np.testing.assert_allclose(h1.numpy(), h0.numpy(), **TOL)
    np.testing.assert_allclose(c1.k.numpy(), c0.k.numpy(), **TOL)
    np.testing.assert_allclose(c1.v.numpy(), c0.v.numpy(), **TOL)


@pytest.fixture(scope="module")
def models():
    jp = jt3.init(jax.random.PRNGKey(0), TINY)
    return jp, port_params(tt3.init, TINY, jp, "T3")


def _voice(rng):
    spk = rng.standard_normal((1, 16)).astype(np.float32)
    prompt = rng.integers(0, 36, (1, 6)).astype(np.int32)
    return (jt3.T3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5),
            tt3.T3Cond(t(spk), t(prompt), 0.5))


def test_generate_defer_tokens_equal_jax(rng, models, monkeypatch):
    jp, tp = models
    jc, tc = _voice(rng)
    text = np.concatenate([[5], rng.integers(1, 50, 11), [0]])[None].astype(np.int32)
    kw = dict(max_new_tokens=30, temperature=0.8, cfg_weight=0.5, seed=2, cfg=TINY)
    plain = tt3.generate(tp, tc, text, draws=JaxDraws(2), **kw, device="cpu")
    monkeypatch.setenv("CHATTERBOX_PALLAS", "1")
    monkeypatch.setenv("CHATTERBOX_DEFER_KV", "1")
    ref = np.asarray(jt3.generate(jp, jc, text, **kw))
    assert jt3.LAST_GENERATION_INFO["use_flash"] is True
    out = tt3.generate(tp, tc, text, draws=JaxDraws(2), **kw, device="cpu")
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, plain)


def test_generate_batch_defer_tokens_equal_jax(rng, models, monkeypatch):
    """Two ragged utterances: the JAX flash kernel's deferred entry with
    per-row holes, against the port's K1s plain version with the same holes."""
    jp, tp = models
    jc, tc = _voice(rng)
    rows = np.zeros((2, 12), np.int32)
    for i, n in enumerate((12, 7)):
        rows[i, :n] = rng.integers(1, 50, (n,))
        rows[i, 0], rows[i, n - 1] = 5, 0
    kw = dict(max_new_tokens=24, temperature=0.8, cfg_weight=0.5, seed=6,
              text_lens=np.array([12, 7], np.int32), cfg=TINY)
    plain = tt3.generate_batch(tp, tc, rows, make_draws=JaxDraws, **kw, device="cpu")
    monkeypatch.setenv("CHATTERBOX_PALLAS", "1")
    monkeypatch.setenv("CHATTERBOX_DEFER_KV", "1")
    ref = jt3.generate_batch(jp, jc, rows, **kw)
    out = tt3.generate_batch(tp, tc, rows, make_draws=JaxDraws, **kw, device="cpu")
    for a, r, p in zip(out, ref, plain):
        np.testing.assert_array_equal(a, np.asarray(r))
        np.testing.assert_array_equal(a, p)
