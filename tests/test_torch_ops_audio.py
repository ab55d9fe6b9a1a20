"""The port's audio front-end ops against the JAX package's, on the CPU in
fp32, same numpy-seeded inputs: resample, the general STFT, the three mels
and the kaldi fbank.

Tolerances. Both sides build banks, windows and sinc kernels in float64
numpy and cast to fp32, so the constants are bit-equal; what differs is the
summation order of the fp32 matmuls and convolutions (XLA at HIGHEST
precision against torch's CPU BLAS). A sum of n products of O(1) terms
differs by about sqrt(n) * 6e-8 relative: resample (n <= ~1.1k taps) and
the STFTs (n = 400 / 1920) get atol 2e-5 on outputs of O(1..30). The log
features amplify the relative error of a small bin: they get atol 2e-4,
except bins at a floor (the 1e-5 / 1e-10 / eps clamps), which are equal."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chatterbox_embed_tpu.ops import fbank as jfbank
from chatterbox_embed_tpu.ops import mel as jmel
from chatterbox_embed_tpu.ops import resample as jres
from chatterbox_embed_tpu.ops import stft as jstft
from chatterbox_embed_tpu_torch.ops import fbank as tfbank
from chatterbox_embed_tpu_torch.ops import mel as tmel
from chatterbox_embed_tpu_torch.ops import resample as tres
from chatterbox_embed_tpu_torch.ops import stft as tstft

torch.set_num_threads(2)


def _voice(seed, n, sr):
    """A few harmonics under an envelope plus low noise, in [-1, 1]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    f0 = 110.0 + 40.0 * rng.random()
    x = sum(np.sin(2 * np.pi * f0 * k * t + rng.random() * 6.28) / k for k in range(1, 6))
    x = 0.2 * x * (0.6 + 0.4 * np.sin(2 * np.pi * 1.5 * t)) + 0.01 * rng.standard_normal(n)
    return x.astype(np.float32)


@pytest.mark.parametrize("src,dst", [(44_100, 16_000), (48_000, 16_000), (22_050, 16_000),
                                     (44_100, 24_000), (48_000, 24_000), (22_050, 24_000),
                                     (24_000, 16_000), (16_000, 24_000)])
@pytest.mark.parametrize("n", [12_000, 12_345])
def test_resample_matches_jax(src, dst, n):
    x = _voice(src + n, n, src)
    ref = np.asarray(jres.resample(jnp.asarray(x), src, dst))
    out = tres.resample(torch.from_numpy(x), src, dst).numpy()
    assert out.shape == ref.shape == (int(np.ceil(n * dst / src)),)
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_resample_kernel_and_batch():
    kj, wj = jres._sinc_kernel(441, 160)
    kt, wt = tres._sinc_kernel(441, 160)
    assert wj == wt
    np.testing.assert_array_equal(kj, kt)
    x = np.stack([_voice(1, 4000, 24_000), _voice(2, 4000, 24_000)])
    ref = np.asarray(jres.resample(jnp.asarray(x), 24_000, 16_000))
    np.testing.assert_allclose(tres.resample(torch.from_numpy(x), 24_000, 16_000).numpy(),
                               ref, atol=2e-5)
    same = torch.from_numpy(x)
    assert tres.resample(same, 16_000, 16_000) is same


@pytest.mark.parametrize("n", [4000, 4321])          # a hop multiple, and not
@pytest.mark.parametrize("n_fft,hop,win,center", [(400, 160, 400, True),
                                                  (512, 128, 400, True),
                                                  (400, 160, 400, False)])
def test_stft_matches_jax(n, n_fft, hop, win, center):
    x = np.stack([_voice(3, n, 16_000), _voice(4, n, 16_000)])
    window = jstft.hann_window(win)
    jr, ji = jstft.stft(jnp.asarray(x), n_fft, hop, window, win_length=win, center=center)
    tr, ti = tstft.stft(torch.from_numpy(x), n_fft, hop, tstft.hann_window(win),
                        win_length=win, center=center)
    assert tuple(tr.shape) == jr.shape
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=2e-5)
    np.testing.assert_allclose(tstft.magnitude(tr, ti, 1e-9).numpy(),
                               np.asarray(jstft.magnitude(jr, ji, 1e-9)), atol=2e-5)


def test_stft_one_dim_and_frame():
    x = _voice(5, 2000, 16_000)
    jr, _ = jstft.stft(jnp.asarray(x), 400, 160, jstft.hann_window(400))
    tr, _ = tstft.stft(torch.from_numpy(x), 400, 160, tstft.hann_window(400))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=2e-5)
    np.testing.assert_array_equal(tstft.frame(torch.from_numpy(x), 400, 160).numpy(),
                                  np.asarray(jstft.frame(jnp.asarray(x), 400, 160)))


def test_filterbanks_equal():
    for args in [(24_000, 1920, 80, 0.0, 8000.0), (16_000, 400, 128), (16_000, 400, 40, 0.0, 8000.0)]:
        np.testing.assert_array_equal(tmel.mel_filterbank(*args), jmel.mel_filterbank(*args))
    np.testing.assert_array_equal(tfbank.kaldi_mel_banks(), jfbank.kaldi_mel_banks())
    np.testing.assert_array_equal(tfbank._povey_window(400), jfbank._povey_window(400))


@pytest.mark.parametrize("n", [480 * 20, 480 * 20 + 123])
def test_mel_24k_matches_jax(n):
    x = np.stack([_voice(6, n, 24_000), _voice(7, n, 24_000)])
    ref = np.asarray(jmel.mel_spectrogram_24k(jnp.asarray(x)))
    out = tmel.mel_spectrogram_24k(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 80, n // 480)
    np.testing.assert_allclose(out, ref, atol=2e-4)


@pytest.mark.parametrize("n", [160 * 50, 160 * 50 + 77])
def test_log_mel_s3tokenizer_matches_jax(n):
    x = np.stack([_voice(8, n, 16_000), _voice(9, n, 16_000)])
    ref = np.asarray(jmel.log_mel_s3tokenizer(jnp.asarray(x)))
    out = tmel.log_mel_s3tokenizer(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 128, n // 160)
    np.testing.assert_allclose(out, ref, atol=2e-4)


@pytest.mark.parametrize("n", [160 * 40, 160 * 40 + 31])
def test_melspectrogram_ve_matches_jax(n):
    x = _voice(10, n, 16_000)
    ref = np.asarray(jmel.melspectrogram_ve(jnp.asarray(x)))
    out = tmel.melspectrogram_ve(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (40, 1 + n // 160)
    # unscaled power mel: values up to ~1e3, so the bound is relative
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n", [16_000, 16_123])
def test_kaldi_fbank_matches_jax(n):
    x = np.stack([_voice(11, n, 16_000), _voice(12, n, 16_000)])
    ref = np.asarray(jfbank.kaldi_fbank(jnp.asarray(x)))
    out = tfbank.kaldi_fbank(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 1 + (n - 400) // 160, 80)
    np.testing.assert_allclose(out, ref, atol=2e-4)
