"""The port's CFM solver options of the batched path against the JAX
package: `generate_mel` with the DeepCache stride (cache_every) and the CFG
interval (cfg_steps), at the same settings on both sides, and the
estimator's `forward_mid_cached` on fresh and reuse steps.

Tolerance: 1e-4 (fp32; ten Euler steps of the estimator, the bound of
tests/test_torch_s3gen.py)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import FlowDecoderConfig
from chatterbox_embed_tpu.models import cfm as jcfm
from chatterbox_embed_tpu.models import flow_decoder as jfd
from chatterbox_embed_tpu_torch.models import cfm as tcfm
from chatterbox_embed_tpu_torch.models import flow_decoder as tfd
from torch_parity import port_params, t

torch.set_num_threads(2)
TIGHT = dict(atol=1e-4, rtol=1e-4)
DEC = FlowDecoderConfig(in_channels=32, out_channels=8, channels=16, attention_head_dim=8,
                        num_heads=2, n_blocks=1, num_mid_blocks=2, time_embed_dim=64)


@pytest.fixture(scope="module")
def estimator():
    jp = jfd.init(jax.random.PRNGKey(3), DEC)
    return jp, port_params(tfd.init, DEC, jp, "flow_decoder")


def _inputs(rng, b=2, tlen=18):
    mu, cond = (rng.standard_normal((b, tlen, 8)).astype(np.float32) for _ in range(2))
    spks = rng.standard_normal((b, 8)).astype(np.float32)
    lens = np.array([tlen, 11, 5, 17][:b])
    mask = (np.arange(tlen)[None, :, None] < lens[:, None, None]).astype(np.float32)
    return mu, spks, cond, mask


@pytest.mark.parametrize("cache_every,cfg_steps,rows", [
    (0, None, 2), (2, None, 2), (0, 4, 2), (2, 4, 2), (2, 4, 4), (3, 7, 2)])
def test_generate_mel_options_match_jax(rng, estimator, cache_every, cfg_steps, rows):
    """rows=4 puts the CFG pair at 8 estimator rows: the port's kernel
    branch (its plain version here) against JAX's written-out attention."""
    jp, tp = estimator
    args = _inputs(rng, rows)
    ref = jcfm.generate_mel(jp, *map(jnp.asarray, args), dec_cfg=DEC,
                            cache_every=cache_every, cfg_steps=cfg_steps)
    out = tcfm.generate_mel(tp, *map(t, args), dec_cfg=DEC, cache_every=cache_every,
                            cfg_steps=cfg_steps)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)


def test_options_off_is_the_plain_solver(rng, estimator):
    """None and 0 give the plain solver exactly; the options do change the
    result when on."""
    _, tp = estimator
    args = tuple(map(t, _inputs(rng)))
    plain = tcfm.generate_mel(tp, *args, dec_cfg=DEC)
    for ce, cs in ((0, None), (None, 0), (1, -1)):
        np.testing.assert_array_equal(
            tcfm.generate_mel(tp, *args, dec_cfg=DEC, cache_every=ce, cfg_steps=cs).numpy(),
            plain.numpy())
    assert (tcfm.generate_mel(tp, *args, dec_cfg=DEC, cache_every=2) - plain).abs().max() > 1e-6


def test_reuse_flags_schedule():
    """Step i reuses the mid stack unless i % K == 0 or it is the last
    step: 6 fresh and 4 reused steps of 10 at K=2."""
    flags = tcfm.reuse_flags(10, 2)
    assert flags == [False, True, False, True, False, True, False, True, False, False]
    assert sum(flags) == 4


@pytest.mark.parametrize("reuse", [False, True])
def test_forward_mid_cached_matches_jax(rng, estimator, reuse):
    jp, tp = estimator
    b, tlen = 2, 16
    x, mu, cond = (rng.standard_normal((b, tlen, 8)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((b, 8)).astype(np.float32)
    mask = (np.arange(tlen)[None, :, None] < np.array([16, 9])[:, None, None]
            ).astype(np.float32)
    tt = np.array([0.2, 0.6], np.float32)
    mid = rng.standard_normal((b, tlen, DEC.channels)).astype(np.float32)
    jv, jmid = jfd.forward_mid_cached(jp, *map(jnp.asarray, (x, mu, tt, spks, cond, mask)),
                                      cfg=DEC, mid_feats=jnp.asarray(mid), reuse_mid=reuse)
    tv, tmid = tfd.forward_mid_cached(tp, *map(t, (x, mu, tt, spks, cond, mask)), cfg=DEC,
                                      mid_feats=t(mid), reuse_mid=reuse)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TIGHT)
    np.testing.assert_allclose(tmid.numpy(), np.asarray(jmid), **TIGHT)
    if not reuse:
        # a fresh step's velocity is the plain forward's
        np.testing.assert_array_equal(
            tv.numpy(), tfd.forward(tp, *map(t, (x, mu, tt, spks, cond, mask)), cfg=DEC).numpy())
