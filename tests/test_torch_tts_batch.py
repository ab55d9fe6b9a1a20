"""The port's ChatterboxTTS.generate_batch against the JAX package's, end to
end at a tiny config: the JAX pipeline's random weights go through
weights.from_jax_params into the port, both get the same Conditionals, and
the port draws JAX's own random numbers (one JaxDraws per T3 sub-batch and
per S3Gen dispatch, as the JAX package reuses its key). The wavs agree to
1e-3 absolute (the HiFT bound of test_torch_tts.py), and equal lengths
mean equal token counts per row. Also the S3Gen dispatch derivations."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chatterbox_embed_tpu.conditionals import Conditionals as JConditionals
from chatterbox_embed_tpu.models.t3 import T3Cond as JT3Cond
from chatterbox_embed_tpu_torch import tts as ttts
from chatterbox_embed_tpu_torch.conditionals import Conditionals
from chatterbox_embed_tpu_torch.models.t3 import T3Cond
from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer
from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
from chatterbox_embed_tpu_torch.weights import from_jax_params
from test_torch_tts import TINY
from torch_parity import JaxDraws, t

torch.set_num_threads(2)
TEXTS = ["Hello from the port.", "A second, somewhat longer sentence.", "Third."]
GEN = dict(max_new_tokens=40, cfg_weight=0.5, temperature=0.7, seed=3)


def _voice(seed, n_prompt):
    """A voice whose T3 prompt is 8 tokens and whose S3Gen prompt is
    `n_prompt` tokens (2 mel frames each)."""
    rng = np.random.default_rng(seed)
    spk = rng.standard_normal((1, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (1, 8)).astype(np.int32)
    gen = dict(prompt_token=rng.integers(0, 6561, (1, n_prompt)).astype(np.int64),
               prompt_token_len=np.array([n_prompt]),
               prompt_feat=rng.standard_normal((1, 2 * n_prompt, 8)).astype(np.float32),
               prompt_feat_len=None,
               embedding=rng.standard_normal((1, 192)).astype(np.float32))
    return (JConditionals(JT3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5), gen),
            Conditionals(T3Cond(t(spk), t(prompt), 0.5), gen))


@pytest.fixture(scope="module")
def pair():
    import chatterbox_embed_tpu.models.t3 as jt3
    import chatterbox_embed_tpu.tts as jtts
    mp = pytest.MonkeyPatch()
    # the JAX package's default buckets (another test file may narrow them)
    mp.setattr(jt3, "_TEXT_BUCKETS", (48, 96, 192, 384, 768))
    mp.setattr(jtts, "_TOKEN_BUCKETS", (128, 256, 512, 1024))
    mp.setenv("CHATTERBOX_PALLAS", "0")
    jax_tts = jtts.ChatterboxTTS.from_random(seed=0, config=TINY)
    jconds, conds = _voice(11, 8)
    jax_tts.conds = jconds
    state = from_jax_params(jax_tts.t3_params, jax_tts.s3gen_params, TINY)
    port = ChatterboxTTS(state["t3"], state["s3gen"], FallbackTokenizer(TINY.t3),
                         conds=conds, config=TINY, device="cpu")
    yield jax_tts, port
    mp.undo()


def _assert_wavs_close(wavs, jwavs):
    assert len(wavs) == len(jwavs)
    for w, jw in zip(wavs, jwavs):
        jw = np.asarray(jw)
        assert w.shape == jw.shape and w.size > 0
        np.testing.assert_allclose(w, jw, atol=1e-3)


def test_generate_batch_single_voice_matches_jax(pair):
    jax_tts, port = pair
    kw = dict(GEN, temperature=[0.6, 0.7, 0.8], exaggeration=[0.3, 0.5, 0.7])
    jwavs = jax_tts.generate_batch(TEXTS, **kw)
    wavs = port.generate_batch(TEXTS, make_draws=JaxDraws, **kw)
    _assert_wavs_close(wavs, jwavs)
    perf = port.perf
    assert perf["batch"] == 3 and perf["speech_tokens"] * 2 * 480 == sum(w.size for w in wavs)
    # 3 rows: 2 + 1 per S3Gen dispatch (a power of two), the exact solver
    assert perf["s3gen_sub_batch"] == 2 and perf["s3gen_dispatches"] == 2
    assert perf["cfm_cache_every"] == 0 and perf["decode_sub_batches"] == 1


def test_generate_batch_multi_voice_matches_jax(pair):
    """Two voices with S3Gen prompts of 8 and 5 tokens (ragged prompts in
    one dispatch), the same T3 prompt length."""
    jax_tts, port = pair
    (ja, ta), (jb, tb) = _voice(11, 8), _voice(12, 5)
    jwavs = jax_tts.generate_batch(TEXTS, conds=[ja, jb, ja], **GEN)
    wavs = port.generate_batch(TEXTS, conds=[ta, tb, ta], make_draws=JaxDraws, **GEN)
    _assert_wavs_close(wavs, jwavs)


def test_generate_batch_default_draws_are_seeded(pair):
    _, port = pair
    a = port.generate_batch(TEXTS[:2], **GEN)
    b = port.generate_batch(TEXTS[:2], **GEN)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
        assert np.isfinite(x).all()


def test_generate_batch_rejects_mismatched_voices(pair):
    _, port = pair
    _, ta = _voice(11, 8)
    with pytest.raises(ValueError, match="Conditionals for"):
        port.generate_batch(TEXTS, conds=[ta, ta], **GEN)
    bare = ChatterboxTTS(port.t3_params, port.s3gen_params, port.tokenizer, config=TINY, device="cpu")
    with pytest.raises(RuntimeError, match="Conditionals are not prepared"):
        bare.generate_batch(TEXTS, **GEN)


def test_derive_s3gen_sub_batch(monkeypatch):
    """Free bytes over 256 KiB per mel frame per utterance (the JAX
    package's model), capped at 16 and u, snapped down to a power of two."""
    monkeypatch.delenv("CHATTERBOX_S3GEN_SUB_BATCH", raising=False)
    per_utt = 256 * 1024 * 2 * (150 + 128)
    assert ttts._derive_s3gen_sub_batch(8, 150 + 128, free_bytes=80 * 10**9) == 8
    assert ttts._derive_s3gen_sub_batch(32, 150 + 128, free_bytes=80 * 10**9) == 16
    assert ttts._derive_s3gen_sub_batch(32, 150 + 128,
                                        free_bytes=int(5.5 * per_utt / 0.7)) == 4
    assert ttts._derive_s3gen_sub_batch(7, 150 + 128, free_bytes=1) == 1
    assert ttts._derive_s3gen_sub_batch(7, 150 + 128, free_bytes=None) == 4
    monkeypatch.setenv("CHATTERBOX_S3GEN_SUB_BATCH", "3")
    assert ttts._derive_s3gen_sub_batch(8, 278, free_bytes=1) == 3


@pytest.mark.parametrize("rows,want", [(7, 0), (8, 2), (16, 2)])
def test_derive_cfm_cache(monkeypatch, rows, want):
    monkeypatch.delenv("CHATTERBOX_CFM_CACHE", raising=False)
    assert ttts._derive_cfm_cache(rows) == want
    monkeypatch.setenv("CHATTERBOX_CFM_CACHE", "3")
    assert ttts._derive_cfm_cache(rows) == 3


def test_derive_cfm_cfg_steps(monkeypatch):
    monkeypatch.delenv("CHATTERBOX_CFM_CFG_STEPS", raising=False)
    assert ttts._derive_cfm_cfg_steps() is None
    monkeypatch.setenv("CHATTERBOX_CFM_CFG_STEPS", "4")
    assert ttts._derive_cfm_cfg_steps() == 4
    monkeypatch.setenv("CHATTERBOX_CFM_CFG_STEPS", "0")
    assert ttts._derive_cfm_cfg_steps() is None
