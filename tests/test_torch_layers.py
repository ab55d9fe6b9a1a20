"""The port's functional layers (models/layers.py) and STFT pair
(ops/stft.py) against the JAX package's, with the port's weight layouts
(weights.py: conv kernels permuted from JAX's (width, in, out)). fp32;
tolerance 1e-5 (summation order only)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chatterbox_embed_tpu.models import layers as jL
from chatterbox_embed_tpu.ops import stft as jstft
from chatterbox_embed_tpu_torch.models import layers as tL
from chatterbox_embed_tpu_torch.ops import stft as tstft
from torch_parity import t

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


def _conv_params(rng, width, d_in, d_out, groups=1):
    w = rng.standard_normal((width, d_in // groups, d_out)).astype(np.float32)
    b = rng.standard_normal((d_out,)).astype(np.float32)
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, {"w": t(w.transpose(2, 1, 0)), "b": t(b)}


@pytest.mark.parametrize("kw", [dict(), dict(padding=1), dict(padding=(2, 0)),
                                dict(padding=(0, 3)), dict(padding="VALID"),
                                dict(stride=2, padding=1), dict(dilation=3, padding=3),
                                dict(stride=3, padding="SAME")])
def test_conv1d(rng, kw):
    jp, tp = _conv_params(rng, 4 if "stride" in kw else 3, 6, 5)
    x = rng.standard_normal((2, 17, 6)).astype(np.float32)
    ref = jL.conv1d(jp, jnp.asarray(x), **kw)
    np.testing.assert_allclose(tL.conv1d(tp, t(x), **kw).numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("stride,width", [(8, 16), (5, 11), (3, 7)])
def test_conv_transpose1d(rng, stride, width):
    # JAX stores (width, out, in); the port (in, out, width)
    w = rng.standard_normal((width, 4, 6)).astype(np.float32)
    b = rng.standard_normal((4,)).astype(np.float32)
    x = rng.standard_normal((1, 9, 6)).astype(np.float32)
    pad = (width - stride) // 2
    ref = jL.conv_transpose1d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                              stride, pad)
    out = tL.conv_transpose1d({"w": t(w.transpose(2, 1, 0)), "b": t(b)}, t(x), stride, pad)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_linear_norms_activations(rng):
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = rng.standard_normal((12, 5)).astype(np.float32)
    b = rng.standard_normal((5,)).astype(np.float32)
    np.testing.assert_allclose(tL.linear({"w": t(w), "b": t(b)}, t(x)).numpy(),
                               np.asarray(jL.linear({"w": w, "b": b}, jnp.asarray(x))), **TOL)
    scale = rng.standard_normal((12,)).astype(np.float32)
    bias = rng.standard_normal((12,)).astype(np.float32)
    for eps in (1e-5, 1e-12):
        np.testing.assert_allclose(
            tL.layer_norm({"scale": t(scale), "bias": t(bias)}, t(x), eps).numpy(),
            np.asarray(jL.layer_norm({"scale": scale, "bias": bias}, jnp.asarray(x), eps)),
            **TOL)
    np.testing.assert_allclose(tL.rms_norm({"scale": t(scale)}, t(x)).numpy(),
                               np.asarray(jL.rms_norm({"scale": scale}, jnp.asarray(x))),
                               **TOL)
    np.testing.assert_allclose(tL.mish(t(x)).numpy(), np.asarray(jL.mish(jnp.asarray(x))),
                               **TOL)
    alpha = np.abs(scale) + 0.1
    np.testing.assert_allclose(tL.snake(t(x), t(alpha)).numpy(),
                               np.asarray(jL.snake(jnp.asarray(x), jnp.asarray(alpha))),
                               **TOL)
    ids = rng.integers(0, 12, (2, 5))
    np.testing.assert_array_equal(tL.embedding({"w": t(w)}, t(ids)).numpy(),
                                  np.asarray(jL.embedding({"w": w}, jnp.asarray(ids))))


@pytest.mark.parametrize("masked", [False, True])
def test_mha(rng, masked):
    q, k, v = (rng.standard_normal((2, n, 3, 8)).astype(np.float32) for n in (5, 9, 9))
    mask = None
    if masked:
        mask = (np.arange(9)[None, None, None, :] < np.array([6, 9])[:, None, None, None])
    ref = jL.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 mask=None if mask is None else jnp.asarray(mask))
    out = tL.mha(t(q), t(k), t(v), mask=None if mask is None else t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_stft_istft(rng):
    x = rng.standard_normal((2, 4800)).astype(np.float32)
    win = jstft.hann_window(16)
    np.testing.assert_array_equal(tstft.hann_window(16), win)
    jr, ji = jstft.stft(jnp.asarray(x), 16, 4, win)
    tr, ti = tstft.stft(t(x), 16, 4, win)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **TOL)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), **TOL)
    ref = jstft.istft(jr, ji, 16, 4, win)
    out = tstft.istft(tr, ti, 16, 4, win)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(out.numpy(), x, atol=1e-4)     # perfect reconstruction
