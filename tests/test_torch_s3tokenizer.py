"""The port's S3 speech tokenizer against the JAX package's on the CPU in
fp32, same random weights, same numpy-seeded inputs.

Tolerance. The encoder's hidden states (two convs, attention + FSMN blocks)
agree to atol 2e-4 on values of O(1..10): fp32 sums in another order. The
tokens are a rounding of tanh(z) * 0.999 at +-0.5, so two correct fp32
implementations may differ where a pre-rounding value lies within their
numerical distance of a boundary. The tests therefore ask for equal tokens
wherever every one of a frame's 8 pre-rounding values is farther than
MARGIN = 1e-3 from +-0.5 (ten times the hidden-state bound through a
projection of norm ~1), and count the frames that are not: with random
weights they are a few per cent at most."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import S3TokenizerConfig
from chatterbox_embed_tpu.models import s3tokenizer as jtok
from chatterbox_embed_tpu_torch.models import s3tokenizer as ttok
from torch_parity import port_params, t

torch.set_num_threads(2)
TINY = S3TokenizerConfig(n_state=64, n_heads=4, n_layers=2, fsmn_kernel=7)
MARGIN = 1e-3


@pytest.fixture(scope="module")
def models():
    jp = jtok.init(jax.random.PRNGKey(5), TINY)
    return jp, port_params(ttok.init, TINY, jp, "S3Tokenizer")


def _safe_frames(tp, hidden):
    """Frames whose 8 pre-rounding values all keep MARGIN from +-0.5."""
    pre = ttok.fsq_pre_round(tp, hidden).numpy()
    return (np.abs(np.abs(pre) - 0.5) > MARGIN).all(axis=-1)


@pytest.mark.parametrize("frames,lens", [(48, (48, 48)), (50, (50, 31)), (37, (37, 20))])
def test_encode_matches_jax(models, frames, lens):
    jp, tp = models
    mels = np.random.default_rng(frames).standard_normal((2, 128, frames)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jh, jl = jtok.encode(jp, jnp.asarray(mels), jnp.asarray(lens), TINY)
    th, tl = ttok.encode(tp, t(mels), t(lens).long(), TINY)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tuple(th.shape) == jh.shape
    for b, n in enumerate(tl.numpy()):                  # valid positions only
        np.testing.assert_allclose(th[b, :n].numpy(), np.asarray(jh)[b, :n], atol=2e-4)


def test_ragged_rows_equal_solo_rows(models):
    """Padding invariance in the port: a short row in a padded batch gives
    the hidden states of the same row alone."""
    _, tp = models
    mels = np.random.default_rng(1).standard_normal((2, 128, 40)).astype(np.float32)
    th, tl = ttok.encode(tp, t(mels), torch.tensor([40, 22]), TINY)
    solo, sl = ttok.encode(tp, t(mels[1:, :, :22]), torch.tensor([22]), TINY)
    assert int(tl[1]) == int(sl[0]) == 6
    np.testing.assert_allclose(th[1, :6].numpy(), solo[0, :6].numpy(), atol=1e-5)


@pytest.mark.parametrize("frames,lens", [(64, (64, 64)), (61, (61, 33))])
def test_quantize_tokens_equal_away_from_boundaries(models, frames, lens):
    jp, tp = models
    mels = np.random.default_rng(100 + frames).standard_normal((2, 128, frames)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jt, jl = jtok.quantize(jp, jnp.asarray(mels), jnp.asarray(lens), TINY)
    tt_, tl = ttok.quantize(tp, t(mels), t(lens).long(), TINY)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tt_.dtype == torch.int64 and int(tt_.min()) >= 0 and int(tt_.max()) < 6561
    th, _ = ttok.encode(tp, t(mels), t(lens).long(), TINY)
    safe = _safe_frames(tp, th)
    valid = np.arange(tt_.shape[1])[None] < tl.numpy()[:, None]
    check = safe & valid
    assert check.sum() >= 0.9 * valid.sum(), (check.sum(), valid.sum())
    np.testing.assert_array_equal(tt_.numpy()[check], np.asarray(jt)[check])


def test_fsq_quantize_matches_jax_on_given_hidden(models):
    jp, tp = models
    h = np.random.default_rng(3).standard_normal((2, 30, TINY.n_state)).astype(np.float32) * 3
    ref = np.asarray(jtok.fsq_quantize(jp, jnp.asarray(h), TINY))
    out = ttok.fsq_quantize(tp, t(h), TINY).numpy()
    safe = _safe_frames(tp, t(h))
    assert safe.mean() > 0.9
    np.testing.assert_array_equal(out[safe], ref[safe])


@pytest.mark.parametrize("n", [16_000, 16_000 + 7, 5 * 640])
def test_pad_and_tokenize_wave(models, n):
    jp, tp = models
    wav = (0.1 * np.random.default_rng(n).standard_normal(n)).astype(np.float32)
    np.testing.assert_array_equal(ttok.pad_to_token_multiple(wav), jtok.pad_to_token_multiple(wav))
    wavp = ttok.pad_to_token_multiple(wav)[None]
    for max_len in (None, 6):
        jt, jl = jtok.tokenize_wave(jp, jnp.asarray(wavp), max_len=max_len, cfg=TINY)
        tt_, tl = ttok.tokenize_wave(tp, t(wavp), max_len=max_len, cfg=TINY)
        assert tuple(tt_.shape) == jt.shape
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        mels = ttok.mel_ops.log_mel_s3tokenizer(t(wavp))
        if max_len is not None:
            mels = mels[..., : max_len * 4]
        th, _ = ttok.encode(tp, mels, torch.tensor([mels.shape[-1]]), TINY)
        safe = _safe_frames(tp, th)
        np.testing.assert_array_equal(tt_.numpy()[safe], np.asarray(jt)[safe])
