"""The port's S3Gen modules against the JAX package at a tiny config:
conformer, flow_decoder (CFM estimator), CFM generate_mel, HiFT inference
(JAX's phase and noise draws fed to the port) and token_to_wav.

Tolerances (fp32):
- conformer, estimator: 1e-4 (summation order through a few blocks);
- mel from generate_mel: 1e-4 (ten Euler steps of the estimator);
- HiFT source: 1e-4 absolute. The sine source takes an fp32 cumsum over
  T*480 samples, and torch and XLA sum in different orders, so the phase
  drifts with the length (measured ~3e-8 at 11.5k samples);
- HiFT and token_to_wav wav: 1e-3 absolute, looser, because the exp()
  magnitude of the iSTFT head amplifies any drift (measured ~1e-4).
"""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import (ConformerConfig, FlowDecoderConfig, HiFTConfig,
                                         S3GenConfig, S3TokenizerConfig, replace)
from chatterbox_embed_tpu.models import cfm as jcfm
from chatterbox_embed_tpu.models import conformer as jconf
from chatterbox_embed_tpu.models import flow_decoder as jfd
from chatterbox_embed_tpu.models import hifigan as jhift
from chatterbox_embed_tpu.models import s3gen as js3
from chatterbox_embed_tpu_torch.models import cfm as tcfm
from chatterbox_embed_tpu_torch.models import conformer as tconf
from chatterbox_embed_tpu_torch.models import flow_decoder as tfd
from chatterbox_embed_tpu_torch.models import hifigan as thift
from chatterbox_embed_tpu_torch.models import s3gen as ts3
from chatterbox_embed_tpu_torch.weights import convert_tree
from chatterbox_embed_tpu_torch.models import layers as L
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)
CONF = ConformerConfig(input_size=32, output_size=32, attention_heads=4, linear_units=64,
                       num_blocks=2, num_up_blocks=1)
DEC = FlowDecoderConfig(in_channels=32, out_channels=8, channels=16, attention_head_dim=8,
                        num_heads=2, n_blocks=1, num_mid_blocks=2, time_embed_dim=64)
HIFT = HiFTConfig(in_channels=8, base_channels=32, f0_cond_channels=16)
S3 = S3GenConfig(flow=replace(S3GenConfig().flow, encoder=CONF, decoder=DEC,
                              input_size=32, output_size=8),
                 hift=HIFT, tokenizer=S3TokenizerConfig(n_state=64, n_heads=4, n_layers=1),
                 mel_num=8)
TIGHT = dict(atol=1e-4, rtol=1e-4)


def test_conformer_matches_jax(rng):
    jp = jconf.init(jax.random.PRNGKey(1), CONF)
    tp = port_params(tconf.init, CONF, jp, "conformer")
    x = rng.standard_normal((1, 13, 32)).astype(np.float32)
    lens = np.array([10], np.int32)
    ref = jconf.forward(jp, jnp.asarray(x), jnp.asarray(lens), CONF)
    out = tconf.forward(tp, t(x), t(lens), CONF)
    assert out.shape == (1, 26, 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)


def _flow_inputs(rng, b=2, tlen=20):
    x, mu, cond = (rng.standard_normal((b, tlen, 8)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((b, 8)).astype(np.float32)
    mask = (np.arange(tlen)[None, :, None] < np.array([tlen, 14])[:b, None, None]
            ).astype(np.float32)
    return x, mu, cond, spks, mask


def test_flow_decoder_matches_jax(rng):
    jp = jfd.init(jax.random.PRNGKey(2), DEC)
    tp = port_params(tfd.init, DEC, jp, "flow_decoder")
    x, mu, cond, spks, mask = _flow_inputs(rng)
    tt = np.array([0.3, 0.8], np.float32)
    ref = jfd.forward(jp, *map(jnp.asarray, (x, mu, tt, spks, cond, mask)), cfg=DEC)
    out = tfd.forward(tp, *map(t, (x, mu, tt, spks, cond, mask)), cfg=DEC)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)


def test_generate_mel_matches_jax(rng):
    np.testing.assert_array_equal(tcfm.fixed_noise(8, 100), jcfm.fixed_noise(8, 100))
    np.testing.assert_array_equal(tcfm.t_span_cosine(10), jcfm.t_span_cosine(10))
    jp = jfd.init(jax.random.PRNGKey(3), DEC)
    tp = port_params(tfd.init, DEC, jp, "flow_decoder")
    _, mu, cond, spks, mask = _flow_inputs(rng, b=1)
    ref = jcfm.generate_mel(jp, *map(jnp.asarray, (mu, spks, cond, mask)), dec_cfg=DEC,
                            cache_every=0, cfg_steps=None)
    out = tcfm.generate_mel(tp, *map(t, (mu, spks, cond, mask)), dec_cfg=DEC)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)


def test_hift_inference_matches_jax(rng):
    jp = jhift.init(jax.random.PRNGKey(4), HIFT)
    tp = port_params(thift.init, HIFT, jp, "hift")
    mel = rng.standard_normal((1, 24, 8)).astype(np.float32)
    f0 = thift.f0_predict(tp["f0_predictor"], t(mel))
    np.testing.assert_allclose(f0.numpy(), np.asarray(jhift.f0_predict(jp["f0_predictor"],
                                                                       jnp.asarray(mel))),
                               **TIGHT)
    jwav, jsrc = jhift.inference(jp, jnp.asarray(mel), key=jax.random.PRNGKey(7), cfg=HIFT)
    twav, tsrc = thift.inference(tp, t(mel), JaxDraws(7), cfg=HIFT)
    assert twav.shape == (1, 24 * 480)
    np.testing.assert_allclose(tsrc.numpy(), np.asarray(jsrc), atol=1e-4)
    np.testing.assert_allclose(twav.numpy(), np.asarray(jwav), atol=1e-3)
    # the decoder alone, from the same source, agrees tightly
    dec = thift.decode(tp, t(mel), t(jsrc), HIFT)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jhift.decode(jp, jnp.asarray(mel),
                                                                    jsrc, HIFT)), **TIGHT)


def test_token_to_wav_matches_jax(rng):
    jp = js3.init(jax.random.PRNGKey(5), S3)
    meta = L.Init(device="meta")
    tp = convert_tree(ts3.init(meta, S3), jp, "S3Gen")
    prompt = rng.integers(0, 6561, (1, 6))
    toks = np.zeros((1, 16), np.int64)
    toks[0, :11] = rng.integers(0, 6561, 11)
    token_len = np.array([6 + 11])
    feat = rng.standard_normal((1, 12, 8)).astype(np.float32)
    emb = rng.standard_normal((1, 192)).astype(np.float32)
    ref = js3.token_to_wav(jp, jnp.asarray(toks, jnp.int32), jnp.asarray(token_len, jnp.int32),
                           jnp.asarray(prompt, jnp.int32), jnp.asarray(feat), jnp.asarray(emb),
                           key=jax.random.PRNGKey(0), cfg=S3)
    jmel = js3.flow_to_mel(jp, jnp.asarray(toks, jnp.int32), jnp.asarray(token_len, jnp.int32),
                           jnp.asarray(prompt, jnp.int32), jnp.asarray(feat), jnp.asarray(emb),
                           cfg=S3, cache_every=0)
    mel = ts3.flow_to_mel(tp, t(toks), t(token_len), t(prompt), t(feat), t(emb), S3)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), **TIGHT)
    wav = ts3.token_to_wav(tp, t(toks), t(token_len), t(prompt), t(feat), t(emb),
                           JaxDraws(0), S3)
    assert wav.shape == ref.shape == (1, 32 * 480)
    np.testing.assert_allclose(wav.numpy(), np.asarray(ref), atol=1e-3)
