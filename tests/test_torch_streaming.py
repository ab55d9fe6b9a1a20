"""The port's streaming modules against the JAX package at a tiny config,
fp32: cfm.generate_mel_stream, s3gen.flow_to_mel_window,
hifigan.stream_synthesize, streaming.WindowedSynth, and the degenerate short
utterance of ChatterboxTTS.stream_generate, with JAX's own draws fed to the
port (tests/torch_parity.py:JaxDraws). test_torch_stream_generate.py holds
the whole stream against the JAX package.

Tolerances:
- CFM, flow window, mu tail: 1e-4 (ten Euler steps of the estimator, fp32
  summation order only; test_torch_s3gen.py's bound);
- vocoder window: 1e-4 on the phase carry, and on the wav of a short window
  (a few thousand samples, so the fp32 cumsum of the phase drifts little);
- a streamed chunk: 1e-3, the bound of the one-shot wav (test_torch_tts.py),
  since the HiFT head's exp() amplifies any drift.
Within the port (one framework) every split of the token feed gives the
same audio exactly."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.models import cfm as jcfm
from chatterbox_embed_tpu.models import hifigan as jhift
from chatterbox_embed_tpu.models import s3gen as js3
from chatterbox_embed_tpu_torch import streaming as tstreaming
from chatterbox_embed_tpu_torch.models import cfm as tcfm
from chatterbox_embed_tpu_torch.models import hifigan as thift
from chatterbox_embed_tpu_torch.models import s3gen as ts3
from torch_parity import JaxDraws, t, tiny_pipeline_config, tiny_tts_pair

torch.set_num_threads(2)
TINY = tiny_pipeline_config()
TIGHT = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    yield tiny_tts_pair(TINY, mp)
    mp.undo()


def _prompt(port):
    gen = port.conds.gen
    return (torch.as_tensor(gen["prompt_token"]), t(gen["prompt_feat"]),
            t(gen["embedding"]))


def test_generate_mel_stream_matches_jax(pair, rng):
    jax_tts, port = pair
    jd, td = jax_tts.s3gen_params["flow"]["decoder"], port.s3gen_params["flow"]["decoder"]
    dec = TINY.s3gen.flow.decoder
    tlen, pf = 40, 16
    mu, cond = (rng.standard_normal((1, tlen, 8)).astype(np.float32) for _ in range(2))
    spks = rng.standard_normal((1, 8)).astype(np.float32)
    mask = (np.arange(tlen)[None, :, None] < 34).astype(np.float32)
    for noise_off in (0, 30, 14990):                 # the last start is clamped
        ref = jcfm.generate_mel_stream(jd, *map(jnp.asarray, (mu, spks, cond, mask)),
                                       prompt_frames=pf, noise_off=jnp.int32(noise_off),
                                       dec_cfg=dec)
        out = tcfm.generate_mel_stream(td, *map(t, (mu, spks, cond, mask)), prompt_frames=pf,
                                       noise_off=noise_off, dec_cfg=dec)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TIGHT)


@pytest.mark.parametrize("later,finalize", [(False, False), (False, True), (True, False),
                                            (True, True)])
def test_flow_to_mel_window_matches_jax(pair, rng, later, finalize):
    """The first window (no context, pin 0, noise 0) and a later one (six
    context tokens pinned, noise at an absolute offset)."""
    jax_tts, port = pair
    pt, pf, emb = _prompt(port)
    toks = np.zeros((1, 22), np.int32)
    vlen = 19 if later else 13
    toks[0, :vlen] = rng.integers(0, 6561, vlen)
    pin = 2 * (6 - 3)
    mu_pin = rng.standard_normal((1, pin, 8)).astype(np.float32) if later else \
        np.zeros((1, pin, 8), np.float32)
    pin_frames, noise_off = (pin, 2 * 17) if later else (0, 0)
    jmel, jtail = js3.flow_to_mel_window(
        jax_tts.s3gen_params, jnp.asarray(toks), jnp.asarray([vlen]), jnp.asarray(pt.numpy(),
                                                                                 jnp.int32),
        jnp.asarray(pf.numpy()), jnp.asarray(emb.numpy()), jnp.asarray(mu_pin), pin_frames,
        noise_off, finalize=finalize, cfg=TINY.s3gen)
    mel, tail = ts3.flow_to_mel_window(
        port.s3gen_params, t(toks), torch.tensor([vlen]), pt, pf, emb, t(mu_pin), pin_frames,
        noise_off, finalize=finalize, cfg=TINY.s3gen)
    assert mel.shape == (1, 44, 8) and tail.shape == (1, pin, 8)
    np.testing.assert_allclose(mel.numpy(), np.asarray(jmel), **TIGHT)
    np.testing.assert_allclose(tail.numpy(), np.asarray(jtail), **TIGHT)


def test_stream_synthesize_matches_jax(pair, rng):
    jax_tts, port = pair
    hcfg = TINY.s3gen.hift
    mel = rng.standard_normal((1, 12, 8)).astype(np.float32)
    carry = rng.uniform(0, 1, (1, hcfg.nb_harmonics + 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    for window, carry_idx in ((0, 3839), (3, 10 ** 6)):      # the second is clamped
        jwav, jcarry = jhift.stream_synthesize(
            jax_tts.s3gen_params["hift"], jnp.asarray(mel), key, jax.random.fold_in(key, window),
            jnp.asarray(carry), carry_idx, cfg=hcfg)
        wav, nxt = thift.stream_synthesize(port.s3gen_params["hift"], t(mel), JaxDraws(5),
                                           window, t(carry), carry_idx, cfg=hcfg)
        assert wav.shape == (1, 12 * 480)
        np.testing.assert_allclose(nxt.numpy(), np.asarray(jcarry), **TIGHT)
        np.testing.assert_allclose(wav.numpy(), np.asarray(jwav), **TIGHT)


def test_degenerate_short_utterance(pair, monkeypatch):
    """max_new_tokens=2 < the pre-lookahead (3): no window is emittable
    before the stream ends, and the final window gives the one chunk. The
    JAX package takes such an utterance through its first-chunk route and
    through its stage-by-stage loop; the port's one route gives their
    chunk."""
    jax_tts, port = pair
    kw = dict(block_tokens=8, throughput_block_tokens=8, max_new_tokens=2, cfg_weight=0.3,
              seed=9)
    out = list(port.stream_generate("Hi.", draws=JaxDraws(9), **kw))
    assert len(out) == 1 and out[0].size == 2 * 480 * port.perf["speech_tokens"] > 0
    for fused in ("0", "1"):
        monkeypatch.setenv("CHATTERBOX_FUSED_FIRST_CHUNK", fused)
        ref = list(jax_tts.stream_generate("Hi.", **kw))
        assert len(ref) == 1
        np.testing.assert_allclose(out[0], ref[0], atol=1e-3)


def test_windowed_synth_block_split_invariance(pair):
    """The same tokens fed in any split give the same audio, bit for bit."""
    _, port = pair
    pt, pf, emb = _prompt(port)
    toks = np.random.default_rng(11).integers(0, 6561, (40,)).astype(np.int32)

    def run(splits):
        synth = tstreaming.WindowedSynth(port.s3gen_params, pt, pf, emb,
                                         draws=JaxDraws(3), cfg=TINY, block_tokens=6,
                                         throughput_block_tokens=24)
        chunks, i = [], 0
        for n in splits:
            chunks.extend(synth.feed(toks[i:i + n]))
            i += n
        chunks.extend(synth.finish())
        return np.concatenate(chunks)

    a = run([6] * 6 + [4])
    np.testing.assert_array_equal(a, run([40]))
    np.testing.assert_array_equal(a, run([1] * 40))
    assert a.size == 2 * 480 * 40
