"""The port's CAMPPlus speaker encoder against the JAX package's on the CPU
in fp32, with the same random weights and numpy-seeded inputs, at a narrow
config and one case at the full width.

Tolerance: some 50 convolutions and eval-form batch norms in fp32, summed in
another order by XLA and by torch; with random weights the 192 outputs are
of O(1). atol 1e-4 (relative ~1e-4) covers the accumulated reordering; a
wrong 2-D kernel layout, stride axis or segment pooling moves outputs by
O(0.1) and more."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import CAMPPlusConfig
from chatterbox_embed_tpu.models import xvector as jxv
from chatterbox_embed_tpu_torch.models import xvector as txv
from torch_parity import port_params, t

torch.set_num_threads(2)
TINY = CAMPPlusConfig(growth_rate=4, bn_size=2, init_channels=16, block_layers=(2, 3, 2))
ATOL = 1e-4


def _params(cfg, seed=0):
    jp = jxv.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)

    def jitter(tree):
        # running stats and affine pairs away from (0, 1), so that the
        # eval-form batch norm is really exercised
        if isinstance(tree, dict):
            if "mean" in tree:
                n = tree["mean"].shape[0]
                return {"mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                        "var": (0.5 + rng.random(n)).astype(np.float32),
                        "scale": (0.8 + 0.4 * rng.random(n)).astype(np.float32),
                        "bias": (0.1 * rng.standard_normal(n)).astype(np.float32)}
            return {k: jitter(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [jitter(v) for v in tree]
        return tree
    jp = jitter(jp)
    return jp, port_params(txv.init, cfg, jp, "CAMPPlus")


@pytest.fixture(scope="module")
def models():
    return _params(TINY)


@pytest.mark.parametrize("frames", [100, 200, 257, 64])   # multiples of the
def test_forward_matches_jax(models, frames):              # 100-frame segment, and not
    jp, tp = models
    feats = np.random.default_rng(frames).standard_normal((2, frames, 80)).astype(np.float32)
    ref = np.asarray(jxv.forward(jp, jnp.asarray(feats), TINY))
    out = txv.forward(tp, t(feats), TINY).numpy()
    assert out.shape == ref.shape == (2, 192)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("t_len", [100, 250, 301])
def test_seg_pool_matches_jax(t_len):
    x = np.random.default_rng(t_len).standard_normal((2, t_len, 6)).astype(np.float32)
    np.testing.assert_allclose(txv._seg_pool_avg(t(x)).numpy(),
                               np.asarray(jxv._seg_pool_avg(jnp.asarray(x))), atol=1e-6)


def test_fcm_matches_jax(models):
    jp, tp = models
    feats = np.random.default_rng(5).standard_normal((1, 37, 80)).astype(np.float32)
    ref = np.asarray(jxv._fcm(jp["fcm"], jnp.asarray(feats)))
    out = txv._fcm(tp["fcm"], t(feats)).numpy()
    assert out.shape == ref.shape == (1, 37, 320)
    np.testing.assert_allclose(out, ref, atol=ATOL)


@pytest.mark.parametrize("n", [16_000, 24_321])
def test_inference_matches_jax(models, n):
    jp, tp = models
    wav = (0.1 * np.random.default_rng(n).standard_normal((2, n))).astype(np.float32)
    ref = np.asarray(jxv.inference(jp, jnp.asarray(wav), TINY))
    out = txv.inference(tp, t(wav), TINY).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_full_width_matches_jax():
    """The published CAMPPlus widths (12/24/16 dense layers, growth 32) on
    1.3 s of audio: 130 frames, so the last pooling segment is short."""
    cfg = CAMPPlusConfig()
    jp, tp = _params(cfg, seed=1)
    wav = (0.1 * np.random.default_rng(2).standard_normal((1, 21_000))).astype(np.float32)
    ref = np.asarray(jxv.inference(jp, jnp.asarray(wav), cfg))
    out = txv.inference(tp, t(wav), cfg).numpy()
    assert out.shape == (1, 192)
    # deeper and wider: the same relative bound on outputs of O(1..10)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)
