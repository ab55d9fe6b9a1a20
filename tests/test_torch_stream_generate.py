"""ChatterboxTTS.stream_generate of the port against the JAX package at a
tiny config, fp32, with JAX's own draws fed to the port (tests/torch_parity.py:
JaxDraws). Both packages stream by two routes, the one-program first chunk
(CHATTERBOX_FUSED_FIRST_CHUNK=1, streaming.first_chunk; on the CPU the
port runs its body eagerly) and the per-block loop (=0), and the port
matches the JAX package on each: the same tokens, the same chunk lengths,
chunks within 1e-3 (the one-shot wav's bound, test_torch_tts.py: the HiFT
head's exp() amplifies fp32 drift). Within the port the fused decode step (K4's plain
version here) gives the same chunks as the default step, and the chunks join
to the whole utterance."""
import numpy as np
import pytest
import torch

from chatterbox_embed_tpu import streaming as jstreaming
from chatterbox_embed_tpu_torch import streaming as tstreaming
from torch_parity import JaxDraws, tiny_pipeline_config, tiny_tts_pair

torch.set_num_threads(2)
TINY = tiny_pipeline_config()
TEXT = "Streaming from the port, one window at a time."
STREAM = dict(block_tokens=8, throughput_block_tokens=16, max_new_tokens=40,
              cfg_weight=0.5, temperature=0.7, seed=9)


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    yield tiny_tts_pair(TINY, mp)
    mp.undo()


def _spy_tokens(monkeypatch, cls, seeded: bool):
    """Record the tokens a WindowedSynth consumes, EOS dropped: every fed
    block, and with `seeded` the tokens the JAX package's first chunk seeds
    it with."""
    got = []
    feed = cls.feed

    def feed_spy(self, block):
        b = np.asarray(block).reshape(-1)
        got.append(b[b < 6561])
        return feed(self, block)

    monkeypatch.setattr(cls, "feed", feed_spy)
    if seeded:
        seed = cls.seed_from_fused

        def seed_spy(self, valid, *a):
            got.append(np.asarray(valid))
            return seed(self, valid, *a)

        monkeypatch.setattr(cls, "seed_from_fused", seed_spy)
    return got


@pytest.mark.parametrize("fused", ["1", "0"])
def test_stream_generate_matches_jax(pair, monkeypatch, fused):
    jax_tts, port = pair
    """`fused` selects the route of both packages."""
    monkeypatch.setenv("CHATTERBOX_FUSED_FIRST_CHUNK", fused)
    jtok = _spy_tokens(monkeypatch, jstreaming.WindowedSynth, seeded=True)
    ref = list(jax_tts.stream_generate(TEXT, **STREAM))
    ttok = _spy_tokens(monkeypatch, tstreaming.WindowedSynth, seeded=fused == "1")
    out = list(port.stream_generate(TEXT, draws=JaxDraws(STREAM["seed"]), **STREAM))
    np.testing.assert_array_equal(np.concatenate(ttok), np.concatenate(jtok))
    assert [c.shape for c in out] == [c.shape for c in ref] and len(out) >= 3
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, atol=1e-3)
    n_tok = port.perf["speech_tokens"]
    assert n_tok == np.concatenate(ttok).size > 16
    assert sum(c.size for c in out) == 2 * 480 * n_tok
    assert port.perf["use_fused"] is False
    assert port.perf["decode_steps"] >= STREAM["max_new_tokens"] or n_tok < 40


def test_stream_fused_step_equals_default_step(pair, monkeypatch):
    """Within the port, with its default draws: the stream through the
    fused decode step (CHATTERBOX_FUSED_STEP=1) and through the default
    step give the same chunks."""
    _, port = pair
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "0")
    plain = list(port.stream_generate(TEXT, **STREAM))
    assert port.perf["use_fused"] is False
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "1")
    fused = list(port.stream_generate(TEXT, **STREAM))
    assert port.perf["use_fused"] is True
    assert len(fused) == len(plain) >= 3
    for a, b in zip(fused, plain):
        np.testing.assert_array_equal(a, b)
    assert sum(c.size for c in fused) == 2 * 480 * port.perf["speech_tokens"]
    assert port.perf["first_chunk_s"] > 0 and port.perf["chunks"] == len(fused)
