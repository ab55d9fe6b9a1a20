"""The port's batched T3 (models/t3.py:generate_batch, ops/sampling.py with
per-row parameters) against the JAX package: per-row logit processing,
then sampled tokens of ragged lock-step batches with JAX's own Gumbel draws
fed to the port, one factory call per sub-batch. Tokens must be equal row
for row.

The JAX decode runs its XLA attention with a key mask here (more than 2
utterances); the port's decode takes the flash-decode kernel's plain
version with per-row holes at every row count. JAX's own
tests/test_t3.py:test_batched_flash_decode_matches_xla shows the two agree."""
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
PER_ROW = dict(temperature=np.array([0.05, 0.8, 1.5, 0.7], np.float32),
               cfg_weight=np.array([0.4, 0.4, 0.0, 0.6], np.float32),
               repetition_penalty=np.array([1.0, 1.2, 1.5, 1.3], np.float32),
               min_p=np.array([0.0, 0.05, 0.0, 0.1], np.float32),
               top_p=np.array([1.0, 0.9, 1.0, 0.95], np.float32))


@pytest.fixture(scope="module")
def models():
    jp = jt3.init(jax.random.PRNGKey(0), TINY)
    return jp, port_params(tt3.init, TINY, jp, "T3")


@pytest.fixture(autouse=True)
def _xla_decode(monkeypatch):
    monkeypatch.setenv("CHATTERBOX_PALLAS", "0")


def _ragged(rng, lens, lt=12):
    rows = np.zeros((len(lens), lt), np.int32)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(1, 50, (n,))
        rows[i, 0] = 5
        rows[i, n - 1] = 0
    return rows, np.asarray(lens, np.int32)


def _voice(rng, rows=1, emotion=0.5):
    spk = rng.standard_normal((rows, 16)).astype(np.float32)
    prompt = rng.integers(0, 36, (rows, 6)).astype(np.int32)
    emo_j = emotion if np.ndim(emotion) == 0 else jnp.asarray(emotion, jnp.float32)
    emo_t = emotion if np.ndim(emotion) == 0 else torch.tensor(emotion, dtype=torch.float32)
    return (jt3.T3Cond(jnp.asarray(spk), jnp.asarray(prompt), emo_j),
            tt3.T3Cond(t(spk), t(prompt), emo_t))


def _assert_rows_equal(outs, refs):
    assert len(outs) == len(refs)
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, np.asarray(ref))


def test_per_row_process_logits_matches_jax(rng):
    """tests/test_t3.py:134-153's case: (U, 1) parameters equal JAX's, and
    equal the stack of per-row scalar calls."""
    u, v = 4, 40
    logits = (rng.standard_normal((u, v)) * 3).astype(np.float32)
    counts = rng.integers(0, 3, (u, v)).astype(np.int32)
    temps = np.array([0.3, 0.8, 1.5, 4.0], np.float32)
    pens = np.array([1.0, 1.2, 1.5, 2.0], np.float32)
    minps = np.array([0.0, 0.05, 0.1, 0.2], np.float32)
    tops = np.array([0.5, 0.8, 0.95, 0.99], np.float32)
    kw = dict(valid_size=36, eos_id=37)
    ref = jsampling.process_logits(
        jnp.asarray(logits), jnp.asarray(counts), temperature=temps.reshape(u, 1),
        repetition_penalty_val=pens.reshape(u, 1), min_p=minps.reshape(u, 1),
        top_p=tops.reshape(u, 1), **kw)
    params = [tsampling.sampling_param(a, u, device="cpu") for a in (temps, pens, minps, tops)]
    vec = tsampling.process_logits(t(logits), t(counts), temperature=params[0],
                                   repetition_penalty_val=params[1], min_p=params[2],
                                   top_p=params[3], **kw)
    np.testing.assert_allclose(vec.numpy(), np.asarray(ref), rtol=1e-6)
    for i in range(u):
        row = tsampling.process_logits(
            t(logits[i:i + 1]), t(counts[i:i + 1]), temperature=float(temps[i]),
            repetition_penalty_val=float(pens[i]), min_p=float(minps[i]),
            top_p=float(tops[i]), **kw)
        np.testing.assert_array_equal(vec[i].numpy(), row[0].numpy())


def test_sampling_param_shapes():
    assert tsampling.sampling_param(0.7, 3, device="cpu") == pytest.approx(0.7)
    assert tuple(tsampling.sampling_param([0.1, 0.2, 0.3], 3, device="cpu").shape) == (3, 1)
    with pytest.raises(ValueError, match="shape"):
        tsampling.sampling_param([0.1, 0.2], 3, device="cpu")


@pytest.mark.parametrize("per_row", [False, True])
def test_generate_batch_ragged_rows_match_jax(rng, models, per_row):
    jp, tp = models
    jc, tc = _voice(rng)
    rows, lens = _ragged(rng, [6, 12, 9, 4])
    params = PER_ROW if per_row else dict(temperature=0.8, cfg_weight=0.5,
                                          repetition_penalty=1.2, min_p=0.05, top_p=0.9)
    kw = dict(max_new_tokens=30, seed=2, text_lens=lens, cfg=TINY, **params)
    ref = jt3.generate_batch(jp, jc, rows, **kw)
    info = {}
    out = tt3.generate_batch(tp, tc, rows, make_draws=JaxDraws, info=info, **kw, device="cpu")
    _assert_rows_equal(out, ref)
    assert info["sub_batches"] == 1 and info["decode_steps"] >= max(len(o) for o in out)


def test_sub_batched_split_matches_jax(rng, models, monkeypatch):
    """A fence of 2 utterances splits 5 rows into 2 + 2 + 1 on both sides;
    sub-batch [s0, s1) samples with seed + s0."""
    jp, tp = models
    jc, tc = _voice(rng)
    rows, lens = _ragged(rng, [6, 12, 9, 4, 11])
    monkeypatch.setenv("CHATTERBOX_MAX_DECODE_UTT", "2")
    monkeypatch.setattr(tt3, "MAX_DECODE_UTTERANCES", 2)
    kw = dict(max_new_tokens=24, seed=5, text_lens=lens, cfg=TINY, temperature=0.9,
              cfg_weight=0.5, top_p=PER_ROW["top_p"].tolist() + [0.8])
    ref = jt3.generate_batch(jp, jc, rows, **kw)
    seeds = []
    info = {}
    out = tt3.generate_batch(tp, tc, rows, info=info,
                             make_draws=lambda s: seeds.append(s) or JaxDraws(s), **kw, device="cpu")
    _assert_rows_equal(out, ref)
    assert seeds == [5, 7, 9]
    assert info["sub_batches"] == 3 and info["sub_batch_utts"] == 2


def test_multi_voice_rows_match_jax(rng, models):
    """One voice per utterance: per-row speaker, prompt and emotion rows
    (the uncond rows keep the full conditioning)."""
    jp, tp = models
    jc, tc = _voice(rng, rows=3, emotion=np.array([0.3, 0.5, 0.9], np.float32))
    np.testing.assert_allclose(tt3.cond_embeds(tp, tc, TINY).numpy(),
                               np.asarray(jt3.cond_embeds(jp, jc, TINY)), atol=1e-5)
    rows, lens = _ragged(rng, [7, 12, 5])
    kw = dict(max_new_tokens=24, seed=1, text_lens=lens, cfg=TINY, temperature=0.8,
              cfg_weight=0.5)
    _assert_rows_equal(tt3.generate_batch(tp, tc, rows, make_draws=JaxDraws, **kw, device="cpu"),
                       jt3.generate_batch(jp, jc, rows, **kw))


def test_shared_voice_with_per_row_emotion(rng, models):
    """A shared voice broadcasts against a (U,) emotion (JAX t3.py:108-115)."""
    jp, tp = models
    jc, tc = _voice(rng)
    emo = np.array([0.2, 0.7, 1.1], np.float32)
    jc = jc._replace(emotion_adv=jnp.asarray(emo))
    tc = tc._replace(emotion_adv=torch.from_numpy(emo))
    ce = tt3.cond_embeds(tp, tc, TINY)
    assert ce.shape[0] == 3
    np.testing.assert_allclose(ce.numpy(), np.asarray(jt3.cond_embeds(jp, jc, TINY)), atol=1e-5)
    rows, lens = _ragged(rng, [9, 12, 6])
    kw = dict(max_new_tokens=16, seed=4, text_lens=lens, cfg=TINY, cfg_weight=0.5)
    _assert_rows_equal(tt3.generate_batch(tp, tc, rows, make_draws=JaxDraws, **kw, device="cpu"),
                       jt3.generate_batch(jp, jc, rows, **kw))


def test_max_decode_utterances_with_free_bytes():
    """The fence at the full config in bf16: 30 layers x 2 x 16 x 64 x 2 B =
    122,880 B per token-row; half the free bytes over capacity x rows."""
    full = T3Config()
    per_row = 30 * 2 * 16 * 64 * 2
    assert tt3.max_decode_utterances(1280, cfg=full, free_bytes=None) == 16
    assert tt3.max_decode_utterances(1280, cfg=full, free_bytes=75 * 10**9) == 16
    # 20 CFG rows fit in half of this: 10 utterances, snapped down to 8
    free = 2 * 20 * 1280 * per_row
    assert tt3.max_decode_utterances(1280, cfg=full, free_bytes=free) == 8
    assert tt3.max_decode_utterances(1280, rows_per_utt=1, cfg=full, free_bytes=free) == 16
    assert tt3.max_decode_utterances(1280, cfg=full, free_bytes=1) == 1
    # fp32 caches take twice the bytes
    assert tt3.max_decode_utterances(1280, cfg=full, dtype=torch.float32, free_bytes=free) == 4


def test_generate_batch_sub_batches_under_free_bytes(rng, models):
    """The explicit free bytes drive the split: 1 utterance per decode."""
    _, tp = models
    _, tc = _voice(rng)
    rows, lens = _ragged(rng, [6, 12, 9])
    info = {}
    out = tt3.generate_batch(tp, tc, rows, max_new_tokens=8, cfg_weight=0.5, text_lens=lens,
                             cfg=TINY, free_bytes=1, info=info, device="cpu")
    assert len(out) == 3 and info["sub_batches"] == 3 and info["sub_batch_utts"] == 1
