"""The port's voice encoder against the JAX package's on the CPU in fp32:
the same random weights (converted with torch_parity.port_params), the same
numpy-seeded mels and wavs.

Tolerance: three LSTM layers over 160 steps of fp32 sigmoids and tanhs, then
an L2 norm; XLA's scan and torch's LSTM order their sums differently, and
the recurrence carries the rounding on. Embeddings are unit vectors with
entries of O(0.1); atol 2e-5 is some 100 ulp of that and far below a wrong
gate order or a dropped bias, which move entries by O(0.1)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import VoiceEncConfig
from chatterbox_embed_tpu.models import voice_encoder as jve
from chatterbox_embed_tpu_torch.models import voice_encoder as tve
from torch_parity import port_params, t

torch.set_num_threads(2)
CFG = VoiceEncConfig()
ATOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jp = jve.init(jax.random.PRNGKey(3), CFG)
    # biases away from each other, so that a port that used one of the two
    # would show
    return jp, port_params(tve.init, CFG, jp, "VoiceEncoder")


def _wav(seed, n):
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / 16_000
    x = 0.3 * np.sin(2 * np.pi * 150 * tt) * (0.5 + 0.5 * np.sin(2 * np.pi * 2 * tt))
    x[: n // 8] *= 0.001                     # a quiet lead for trim_silence
    return (x + 0.005 * rng.standard_normal(n)).astype(np.float32)


def test_forward_matches_jax(models):
    jp, tp = models
    mels = np.random.default_rng(0).random((5, 160, 40)).astype(np.float32) * 3.0
    ref = np.asarray(jve.forward(jp, jnp.asarray(mels), CFG))
    out = tve.forward(tp, t(mels), CFG).numpy()
    assert out.shape == ref.shape == (5, 256)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_forward_uses_both_biases_and_gate_order(models):
    jp, tp = models
    mels = np.random.default_rng(1).random((2, 160, 40)).astype(np.float32)
    ref = tve.forward(tp, t(mels), CFG).numpy()
    # either fault moves the embedding by far more than the parity bound
    broken = dict(tp, lstm=[dict(l, bh=torch.zeros_like(l["bh"])) for l in tp["lstm"]])
    assert np.abs(tve.forward(broken, t(mels), CFG).numpy() - ref).max() > 10 * ATOL
    h = CFG.ve_hidden_size

    def swap_i_g(w):                          # gate blocks i, f, g, o -> g, f, i, o
        return torch.cat([w[..., 2 * h:3 * h], w[..., h:2 * h], w[..., :h], w[..., 3 * h:]], -1)
    swapped = dict(tp, lstm=[{k: swap_i_g(v) for k, v in l.items()} for l in tp["lstm"]])
    assert np.abs(tve.forward(swapped, t(mels), CFG).numpy() - ref).max() > 10 * ATOL


@pytest.mark.parametrize("n_frames", [120, 160, 301, 500])
def test_embed_utterance_matches_jax(models, n_frames):
    jp, tp = models
    mel = np.random.default_rng(n_frames).random((n_frames, 40)).astype(np.float32) * 2.0
    ref = np.asarray(jve.embed_utterance(jp, jnp.asarray(mel), CFG))
    out = tve.embed_utterance(tp, t(mel), CFG).numpy()
    assert out.shape == (256,)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("sr", [16_000, 24_000])
def test_embeds_from_wavs_matches_jax(models, sr):
    jp, tp = models
    wavs = [_wav(1, 2 * sr), _wav(2, 3 * sr + 123)]
    ref = jve.embeds_from_wavs(jp, wavs, sr, CFG)
    out = tve.embeds_from_wavs(tp, wavs, sr, CFG)
    assert out.shape == ref.shape == (2, 256) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("top_db", [20.0, 30.0, 40.0])
def test_trim_silence_equal(top_db):
    wav = _wav(4, 40_000)
    ref = jve.trim_silence(wav, top_db=top_db)
    out = tve.trim_silence(wav, top_db=top_db)
    np.testing.assert_array_equal(out, ref)
    assert 0 < len(out) < len(wav) or top_db == 40.0
    short = wav[:1000]
    assert tve.trim_silence(short) is short
    assert tve._frame_step(CFG, rate=1.3) == jve._frame_step(CFG, rate=1.3) == 77
    assert tve._num_wins(300, 77, 0.8, CFG) == jve._num_wins(300, 77, 0.8, CFG)
