"""The port's ChatterboxVC against the JAX package's, on the CPU in fp32 at
a tiny config, with the JAX pipeline's random weights and JAX's own draws:
voice conversion (`generate`), profile-based TTS (`tts`),
`inference_from_text`, voice profiles and `clean_audio`.

Tolerances: wavs within 1e-3 (the HiFT bound of test_torch_s3gen.py; the
watermark and the peak normalisation are the same numpy code on both
sides); the source's speech tokens must be equal (the source is fixed by a
seed for which no pre-rounding value lies within 1e-3 of a rounding
boundary, asserted); `clean_audio` is numpy and scipy on both sides and
agrees to 1e-6."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chatterbox_embed_tpu_torch.models import s3tokenizer as ttok
from chatterbox_embed_tpu_torch.ops import mel as tmel
from chatterbox_embed_tpu_torch.utils import audio_io
from chatterbox_embed_tpu_torch.vc import ChatterboxVC
from chatterbox_embed_tpu_torch.weights import from_jax_params
from test_torch_conditioning import CFG, voice
from torch_parity import JaxDraws

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    import chatterbox_embed_tpu.models.t3 as jt3
    import chatterbox_embed_tpu.vc as jvc
    mp = pytest.MonkeyPatch()
    mp.setattr(jt3, "_TEXT_BUCKETS", (48, 96, 192, 384, 768))
    mp.setattr(jvc, "_TOKEN_BUCKETS", (128, 256, 512, 1024))
    jax_vc = jvc.ChatterboxVC.from_random(seed=0, config=CFG)
    state = from_jax_params(jax_vc.t3_params, jax_vc.s3gen_params, CFG,
                            ve_params=jax_vc.ve_params)
    port = ChatterboxVC(state["s3gen"], state["t3"], state["ve"], jax_vc.tokenizer, config=CFG,
                        device="cpu")
    d = tmp_path_factory.mktemp("vc")
    paths = {"target": str(d / "target.wav"), "source": str(d / "source.wav")}
    audio_io.write_wav(paths["target"], voice(1, 2.4, 24_000), 24_000)
    audio_io.write_wav(paths["source"], voice(4, 1.53, 16_000), 16_000)
    yield jax_vc, port, paths, d
    mp.undo()


def _safe(port, wav16):
    wavp = ttok.pad_to_token_multiple(wav16)[None]
    mels = tmel.log_mel_s3tokenizer(torch.from_numpy(wavp))
    h, _ = ttok.encode(port.s3gen_params["tokenizer"], mels, torch.tensor([mels.shape[-1]]),
                       CFG.s3gen.tokenizer)
    pre = ttok.fsq_pre_round(port.s3gen_params["tokenizer"], h).numpy()
    return bool((np.abs(np.abs(pre) - 0.5) > 1e-3).all())


def test_generate_matches_jax_from_path_and_array(pair):
    jax_vc, port, paths, _ = pair
    src16, _ = audio_io.load_audio(paths["source"], sr=16_000, device="cpu")
    assert _safe(port, src16)
    jwav = np.asarray(jax_vc.generate(paths["source"], target_voice_path=paths["target"], seed=2))
    wav = port.generate(paths["source"], target_voice_path=paths["target"], seed=2,
                        draws=JaxDraws(2))
    n_tok = int(np.ceil(len(src16) / 640))
    assert wav.shape == jwav.shape == (1, 2 * n_tok * 480) and wav.dtype == np.float32
    np.testing.assert_allclose(wav, jwav, atol=1e-3)
    np.testing.assert_allclose(port.ve_embedding, jax_vc.ve_embedding, atol=2e-5)
    # an in-memory 16 kHz waveform, the target voice kept
    wav2 = port.generate(src16, seed=2, draws=JaxDraws(2))
    np.testing.assert_allclose(wav2, wav, atol=1e-6)
    # default draws are seeded
    np.testing.assert_array_equal(port.generate(src16, seed=5), port.generate(src16, seed=5))


def test_generate_needs_a_target(pair):
    _, port, paths, _ = pair
    bare = ChatterboxVC(port.s3gen_params, config=CFG, device="cpu")
    with pytest.raises(RuntimeError, match="no target voice set"):
        bare.generate(paths["source"])
    with pytest.raises(RuntimeError, match="needs T3 and a tokenizer"):
        bare.tts("hello")


def test_profiles_and_tts_match_jax(pair, monkeypatch):
    jax_vc, port, paths, d = pair
    # `tts` asks T3 for up to 1000 tokens, more than the tiny config's speech
    # positions (random weights emit no EOS): both packages' T3 is cut to 40
    import chatterbox_embed_tpu.models.t3 as jt3
    import chatterbox_embed_tpu_torch.models.t3 as tt3
    for mod in (jt3, tt3):
        monkeypatch.setattr(mod, "generate", (lambda fn: lambda *a, **k: fn(
            *a, **{**k, "max_new_tokens": 40}))(mod.generate))
    jax_vc.save_voice_profile(paths["target"], str(d / "j.npy"))
    port.save_voice_profile(paths["target"], str(d / "t.npy"))
    a, b = port.load_voice_profile(str(d / "t.npy")), jax_vc.load_voice_profile(str(d / "j.npy"))
    np.testing.assert_array_equal(a.prompt_token, b.prompt_token)
    np.testing.assert_allclose(a.ve_embedding, b.ve_embedding, atol=2e-5)
    np.testing.assert_allclose(a.embedding, b.embedding, atol=1e-4)
    # the same file on both sides
    for vc in (jax_vc, port):
        vc.ve_embedding = None
        prof = vc.set_voice_profile(str(d / "j.npy"))
        assert prof.ve_embedding is not None
    np.testing.assert_array_equal(port.ve_embedding, jax_vc.ve_embedding)
    for k in ("prompt_token", "prompt_feat", "embedding"):
        np.testing.assert_array_equal(port.ref_dict[k], jax_vc.ref_dict[k])
    assert port.ref_dict["prompt_feat_len"] is None
    kw = dict(temperature=0.7, cfg_weight=0.4, exaggeration=0.6, seed=1)
    jwav = np.asarray(jax_vc.tts("hello from the port", **kw))
    wav = port.tts("hello from the port", draws=JaxDraws(1), **kw)
    assert wav.shape == jwav.shape and wav.shape[1] % 960 == 0
    np.testing.assert_allclose(wav, jwav, atol=1e-3)
    assert abs(np.abs(wav).max() - 10 ** (-1.0 / 20.0)) < 1e-4       # -1 dBFS peak
    # through voice_profile_path, from a fresh object
    fresh = ChatterboxVC(port.s3gen_params, port.t3_params, port.ve_params, port.tokenizer,
                         config=CFG, device="cpu")
    wav2 = fresh.tts("hello from the port", voice_profile_path=str(d / "j.npy"),
                     draws=JaxDraws(1), **kw)
    np.testing.assert_allclose(wav2, wav, atol=1e-6)


def test_inference_from_text_with_and_without_encoder(pair):
    jax_vc, port, paths, _ = pair
    for vc in (jax_vc, port):
        vc.set_target_voice(paths["target"])
        vc.text_encoder = None
        with pytest.raises(RuntimeError, match="no `text_encoder` attached"):
            vc.inference_from_text("hi", vc.ref_dict)
    toks = np.random.default_rng(0).integers(0, 6561, 20)

    class Enc:
        def encode(self, text):
            return list(toks) + [6561, 6562]          # non-speech ids are dropped

    ref = dict(jax_vc.ref_dict)
    jax_vc.text_encoder, port.text_encoder = Enc(), Enc()
    jwav = np.asarray(jax_vc.inference_from_text("hi", ref, seed=3))
    wav = port.inference_from_text("hi", ref, seed=3, draws=JaxDraws(3))
    assert wav.shape == jwav.shape == (2 * 20 * 480,)
    np.testing.assert_allclose(wav, jwav, atol=1e-3)
    port.text_encoder = lambda text: toks                  # a bare callable
    np.testing.assert_allclose(port.inference_from_text("hi", ref, draws=JaxDraws(3)), wav,
                               atol=1e-6)
    port.text_encoder = 7
    with pytest.raises(RuntimeError, match="neither"):
        port.inference_from_text("hi", ref)
    assert port.ref_dict is not ref                        # the set voice is restored


@pytest.mark.parametrize("stationary", ["0", "1"])
def test_clean_audio_matches_jax(pair, tmp_path, monkeypatch, stationary):
    jax_vc, port, _, _ = pair
    monkeypatch.setenv("CHATTERBOX_CLEAN_STATIONARY", stationary)
    rng = np.random.default_rng(6)
    noisy = voice(7, 3.0, 16_000) + 0.02 * rng.standard_normal(48_000).astype(np.float32)
    noisy = noisy + 0.05 * np.sin(2 * np.pi * 50.0 * np.arange(48_000) / 16_000).astype(np.float32)
    for name in ("j", "t"):
        audio_io.write_wav(str(tmp_path / f"{name}.wav"), noisy, 16_000)
    jout = jax_vc.clean_audio(str(tmp_path / "j.wav"))
    tout = port.clean_audio(str(tmp_path / "t.wav"))
    assert tout.endswith("t_clean.wav") and jout.endswith("j_clean.wav")
    a, asr = audio_io.read_wav(tout)
    b, bsr = audio_io.read_wav(jout)
    assert asr == bsr == 16_000 and a.shape == b.shape and 0 < len(a) <= len(noisy)
    np.testing.assert_allclose(a, b, atol=1e-6)
    assert port.clean_audio(str(tmp_path / "t.wav"), str(tmp_path / "o.wav")).endswith("o.wav")


def test_from_pretrained_downloads_the_checkpoint_then_loads_it(pair, tmp_path, monkeypatch):
    """ChatterboxVC.from_pretrained asks the hub (a stand-in module: no
    network) for the five files of ResembleAI/chatterbox, then loads their
    folder through from_local: here s3gen (its converter stubbed to hand
    back the pipeline's tree, as test_torch_tts.py:stub_checkpoint does) and
    conds.pt, whose S3Gen half becomes the target voice; without
    huggingface_hub it raises."""
    import sys
    from chatterbox_embed_tpu_torch.conditionals import Conditionals
    from chatterbox_embed_tpu_torch.models.t3 import T3Cond
    from chatterbox_embed_tpu_torch.utils import weights as tw
    from test_torch_tts import CHECKPOINT_FILES, StandInHub
    _, port, _, _ = pair

    def arrays(tree):
        if isinstance(tree, dict):
            return {k: arrays(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [arrays(v) for v in tree]
        return tree.numpy()

    read = []
    monkeypatch.setattr(tw, "load_safetensors", lambda p: read.append(p) or {"path": p})
    monkeypatch.setattr(tw, "convert_s3gen", lambda sd, cfg: arrays(port.s3gen_params))
    rng = np.random.default_rng(3)
    gen = dict(prompt_token=rng.integers(0, 6561, (1, 8)).astype(np.int64),
               prompt_token_len=np.array([8]),
               prompt_feat=rng.standard_normal((1, 16, CFG.s3gen.mel_num)).astype(np.float32),
               prompt_feat_len=None, embedding=rng.standard_normal((1, 192)).astype(np.float32))
    Conditionals(T3Cond(torch.zeros((1, 256)), None, 0.5), gen).save(str(tmp_path / "conds.pt"))
    hub = StandInHub(tmp_path)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module)
    loaded = ChatterboxVC.from_pretrained(device="cpu", config=CFG)
    assert hub.asked == [("ResembleAI/chatterbox", f) for f in CHECKPOINT_FILES]
    assert [p.rsplit("/", 1)[-1] for p in read] == ["s3gen.safetensors"]
    assert loaded.device == torch.device("cpu") and loaded.t3_params is None
    np.testing.assert_array_equal(loaded.ref_dict["prompt_feat"], gen["prompt_feat"])
    np.testing.assert_array_equal(
        loaded.s3gen_params["flow"]["input_embedding"]["w"].numpy(),
        port.s3gen_params["flow"]["input_embedding"]["w"].numpy())
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match=r"huggingface_hub unavailable; use from_local\(\)"):
        ChatterboxVC.from_pretrained(device="cpu", config=CFG)
