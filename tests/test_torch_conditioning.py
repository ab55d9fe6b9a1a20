"""Voice conditioning in the port against the JAX package's, on the CPU in
fp32 at a tiny config: `embed_ref` key by key, the VoiceProfile `.npy` format
across the two packages, the three `prepare_conditionals_*` routes, the
conditional cache, and `generate(audio_prompt_path=...)` end to end with
JAX's own draws.

Tolerances. Prompt mel (log of a clamped mel): atol 2e-4, as
test_torch_ops_audio.py. CAMPPlus x-vector and voice-encoder embedding:
atol 1e-4 / 2e-5, as test_torch_xvector.py / test_torch_voice_encoder.py.
Speech tokens are a rounding (test_torch_s3tokenizer.py): the reference
audio here is fixed by a seed, for which no pre-rounding value lies within
1e-3 of a boundary (asserted), so the tokens must be equal, and with equal
tokens the end-to-end wav agrees to 1e-3 as in test_torch_tts.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chatterbox_embed_tpu.config import CAMPPlusConfig, S3TokenizerConfig, replace
from chatterbox_embed_tpu.models import s3gen as js3gen
from chatterbox_embed_tpu_torch.models import s3gen as ts3gen
from chatterbox_embed_tpu_torch.models import s3tokenizer as ttok
from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer
from chatterbox_embed_tpu_torch.ops import mel as tmel
from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
from chatterbox_embed_tpu_torch.utils import audio_io
from chatterbox_embed_tpu_torch.weights import from_jax_params
from torch_parity import JaxDraws, tiny_pipeline_config

torch.set_num_threads(2)
_BASE = tiny_pipeline_config()
CFG = replace(_BASE, s3gen=replace(
    _BASE.s3gen,
    campplus=CAMPPlusConfig(growth_rate=4, bn_size=2, init_channels=16, block_layers=(2, 2, 2)),
    tokenizer=S3TokenizerConfig(n_state=64, n_heads=4, n_layers=1, fsmn_kernel=7)))
TEXT = "Hello from the port."
GEN = dict(max_new_tokens=60, cfg_weight=0.5, temperature=0.7, seed=3)
MEL_ATOL, XVEC_ATOL, VE_ATOL = 2e-4, 1e-4, 2e-5


def voice(seed: int, seconds: float, sr: int) -> np.ndarray:
    """Drifting harmonics under an envelope plus low noise, with a quiet
    lead and tail for trim_silence."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    f0 = 120.0 + 15.0 * np.sin(2 * np.pi * 0.7 * tt)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum(np.sin(k * phase + rng.random() * 6.28) / k for k in range(1, 7))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 2.1 * tt)
    env[: n // 10] *= 0.002
    env[-n // 12:] *= 0.002
    return (0.18 * x * env + 0.003 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    import chatterbox_embed_tpu.models.t3 as jt3
    import chatterbox_embed_tpu.tts as jtts
    mp = pytest.MonkeyPatch()
    mp.setattr(jt3, "_TEXT_BUCKETS", (48, 96, 192, 384, 768))
    mp.setattr(jtts, "_TOKEN_BUCKETS", (128, 256, 512, 1024))
    jax_tts = jtts.ChatterboxTTS.from_random(seed=0, config=CFG)
    state = from_jax_params(jax_tts.t3_params, jax_tts.s3gen_params, CFG,
                            ve_params=jax_tts.ve_params)
    port = ChatterboxTTS(state["t3"], state["s3gen"], FallbackTokenizer(CFG.t3), config=CFG,
                         device="cpu", ve_params=state["ve"])
    d = tmp_path_factory.mktemp("voices")
    paths = {}
    for name, seed, seconds, sr in (("ref24", 1, 2.4, 24_000), ("ref16", 2, 1.71, 16_000),
                                    ("ref22", 3, 1.5, 22_050)):
        paths[name] = str(d / f"{name}.wav")
        audio_io.write_wav(paths[name], voice(seed, seconds, sr), sr)
    yield jax_tts, port, paths, d
    mp.undo()


def _safe_frames(port, wav16: np.ndarray, max_len=None) -> np.ndarray:
    """(T,) bool: the token frames of this wav none of whose pre-rounding
    values lies within 1e-3 of +-0.5."""
    wavp = ttok.pad_to_token_multiple(wav16)[None]
    mels = tmel.log_mel_s3tokenizer(torch.from_numpy(wavp))
    if max_len is not None:
        mels = mels[..., : 4 * max_len]
    h, _ = ttok.encode(port.s3gen_params["tokenizer"], mels, torch.tensor([mels.shape[-1]]),
                       CFG.s3gen.tokenizer)
    pre = ttok.fsq_pre_round(port.s3gen_params["tokenizer"], h).numpy()
    return (np.abs(np.abs(pre) - 0.5) > 1e-3).all(axis=-1)[0]


def _tokens_are_safe(port, wav16: np.ndarray, max_len=None) -> bool:
    return bool(_safe_frames(port, wav16, max_len).all())


def _assert_gen_close(tg, jg, safe=None):
    """`safe`: the token frames to compare (None: all of them)."""
    assert set(tg) == set(jg) == {"prompt_token", "prompt_token_len", "prompt_feat",
                                  "prompt_feat_len", "embedding"}
    for k in tg:
        if tg[k] is None:
            assert jg[k] is None
            continue
        a, b = np.asarray(tg[k]), np.asarray(jg[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.shape, b.shape, a.dtype, b.dtype)
    n = np.asarray(tg["prompt_token"]).shape[1]
    safe = np.ones(n, bool) if safe is None else safe[:n]
    np.testing.assert_array_equal(np.asarray(tg["prompt_token"])[:, safe],
                                  np.asarray(jg["prompt_token"])[:, safe])
    np.testing.assert_array_equal(tg["prompt_token_len"], jg["prompt_token_len"])
    np.testing.assert_allclose(tg["prompt_feat"], jg["prompt_feat"], atol=MEL_ATOL)
    np.testing.assert_allclose(tg["embedding"], jg["embedding"], atol=XVEC_ATOL)


@pytest.mark.parametrize("name", ["ref24", "ref16", "ref22"])
def test_embed_ref_matches_jax_key_by_key(pair, name):
    jax_tts, port, paths, _ = pair
    wav, sr = audio_io.load_audio(paths[name])
    wav16, _ = audio_io.load_audio(paths[name], sr=16_000, device="cpu")
    # tokens are compared away from rounding boundaries: every frame of the
    # voice that the end-to-end tests use, most frames of the others
    safe = _safe_frames(port, wav16)
    assert safe.all() if name == "ref24" else safe.mean() >= 0.9
    jrd = js3gen.embed_ref(jax_tts.s3gen_params, wav, sr, CFG.s3gen)
    timings = {}
    trd = ts3gen.embed_ref(port.s3gen_params, wav, sr, CFG.s3gen, timings=timings)
    _assert_gen_close(trd, jrd, safe)
    n_tok = trd["prompt_token"].shape[1]
    # 2.4 s is whole tokens: 2 mel frames a token; a ragged length keeps its odd frame
    n_mel = trd["prompt_feat"].shape[1]
    assert n_mel == 2 * n_tok if name == "ref24" else n_mel in (2 * n_tok, 2 * n_tok + 1)
    assert trd["prompt_feat"].shape[2] == CFG.s3gen.mel_num
    assert trd["embedding"].shape == (1, 192) and trd["prompt_token"].dtype == np.int64
    assert set(timings) == {"resample_s", "mel_s", "campplus_s", "tokenizer_s"}


def test_embed_ref_trims_tokens_to_the_mel(pair):
    """When the mel has fewer than 2 frames a token, the tokens are cut
    (both packages): a 24 kHz wav of 2.01 s gives 101 mel frames (padded to
    a hop), 51 tokens, so 50 are kept."""
    jax_tts, port, _, _ = pair
    wav = voice(9, 2.01, 24_000)
    jrd = js3gen.embed_ref(jax_tts.s3gen_params, wav, 24_000, CFG.s3gen)
    trd = ts3gen.embed_ref(port.s3gen_params, wav, 24_000, CFG.s3gen)
    assert trd["prompt_feat"].shape[1] == 101 and trd["prompt_token"].shape[1] == 50
    assert jrd["prompt_token"].shape == trd["prompt_token"].shape
    np.testing.assert_array_equal(trd["prompt_token_len"], jrd["prompt_token_len"])
    np.testing.assert_allclose(trd["prompt_feat"], jrd["prompt_feat"], atol=MEL_ATOL)


def test_voice_profile_files_cross_packages(pair):
    """A profile written by one package loads in the other with equal
    arrays; the same contents written by both give byte-equal files, with
    and without the optional fields (prompt_feat_len=None survives)."""
    jax_tts, port, paths, d = pair
    jax_tts.save_voice_profile(paths["ref24"], str(d / "j.npy"))
    port.save_voice_profile(paths["ref24"], str(d / "t.npy"))
    jp, tp = port.load_voice_profile(str(d / "j.npy")), jax_tts.load_voice_profile(str(d / "t.npy"))
    assert jp.prompt_feat_len is None and tp.prompt_feat_len is None
    _assert_gen_close({k: getattr(tp, k) for k in ("prompt_token", "prompt_token_len",
                                                   "prompt_feat", "prompt_feat_len", "embedding")},
                      {k: getattr(jp, k) for k in ("prompt_token", "prompt_token_len",
                                                   "prompt_feat", "prompt_feat_len", "embedding")})
    np.testing.assert_allclose(tp.ve_embedding, jp.ve_embedding, atol=VE_ATOL)
    assert tp.ve_embedding.shape == (1, 256) and tp.ve_embedding.dtype == np.float32
    # the same contents through both classes: byte-equal files
    fields = {k: getattr(jp, k) for k in ("embedding", "prompt_feat", "prompt_feat_len",
                                          "prompt_token", "prompt_token_len", "ve_embedding")}
    for keep in (tuple(fields), ("embedding",), ("embedding", "prompt_token", "ve_embedding")):
        kw = {k: v for k, v in fields.items() if k in keep}
        js3gen.VoiceProfile(**kw).save(str(d / "j2.npy"))
        ts3gen.VoiceProfile(**kw).save(str(d / "t2.npy"))
        assert (d / "j2.npy").read_bytes() == (d / "t2.npy").read_bytes()
        back = ts3gen.VoiceProfile.load(str(d / "j2.npy"))
        for k in fields:
            if k in keep and fields[k] is not None:
                np.testing.assert_array_equal(getattr(back, k), fields[k])
            else:
                assert getattr(back, k) is None


def test_save_voice_clone_matches_jax(pair):
    jax_tts, port, paths, d = pair
    jax_tts.save_voice_clone(paths["ref16"], str(d / "jc.npy"))
    port.save_voice_clone(paths["ref16"], str(d / "tc.npy"))
    j, t_ = np.load(str(d / "jc.npy")), port.load_voice_clone(str(d / "tc.npy"))
    assert t_.shape == j.shape == (1, 192) and t_.dtype == j.dtype
    np.testing.assert_allclose(t_, j, atol=XVEC_ATOL)
    wav, sr = audio_io.load_audio(paths["ref24"])
    ts3gen.save_voice_profile(port.s3gen_params, wav, sr, str(d / "tp.npy"), CFG.s3gen)
    js3gen.save_voice_profile(jax_tts.s3gen_params, wav, sr, str(d / "jp.npy"), CFG.s3gen)
    a, b = ts3gen.VoiceProfile.load(str(d / "tp.npy")), js3gen.VoiceProfile.load(str(d / "jp.npy"))
    assert a.ve_embedding is None and b.ve_embedding is None
    np.testing.assert_array_equal(a.prompt_token, b.prompt_token)


def _assert_conds_close(tc, jc):
    np.testing.assert_allclose(tc.t3.speaker_emb.numpy(), np.asarray(jc.t3.speaker_emb),
                               atol=VE_ATOL)
    np.testing.assert_array_equal(tc.t3.cond_prompt_speech_tokens.numpy(),
                                  np.asarray(jc.t3.cond_prompt_speech_tokens))
    assert tc.t3.cond_prompt_speech_tokens.shape == (1, CFG.t3.speech_cond_prompt_len)
    assert tc.t3.emotion_adv == jc.t3.emotion_adv
    _assert_gen_close(tc.gen, jc.gen)


@pytest.mark.parametrize("route", ["audio_prompt", "saved_voice", "voice_profile"])
def test_prepare_routes_match_jax(pair, route):
    jax_tts, port, paths, d = pair
    wav16, _ = audio_io.load_audio(paths["ref24"], sr=16_000, device="cpu")
    assert _tokens_are_safe(port, wav16[: port.ENC_COND_LEN], CFG.t3.speech_cond_prompt_len)
    if route == "audio_prompt":
        args = (paths["ref24"], 0.7)
        jax_tts.prepare_conditionals_with_audio_prompt(*args)
        timings = {}
        port.prepare_conditionals_with_audio_prompt(*args, timings=timings)
        assert set(timings) == {"resample_s", "mel_s", "campplus_s", "tokenizer_s",
                                "voice_encoder_s"}
    elif route == "saved_voice":
        jax_tts.save_voice_clone(paths["ref22"], str(d / "saved.npy"))
        args = (str(d / "saved.npy"), paths["ref24"], 0.4)
        jax_tts.prepare_conditionals_with_saved_voice(*args)
        port.prepare_conditionals_with_saved_voice(*args)
        np.testing.assert_array_equal(port.conds.gen["embedding"], np.load(str(d / "saved.npy")))
    else:
        jax_tts.save_voice_profile(paths["ref24"], str(d / "route.npy"))
        jax_tts.prepare_conditionals_with_voice_profile(str(d / "route.npy"), 0.6)
        port.prepare_conditionals_with_voice_profile(str(d / "route.npy"), 0.6)
        # the same file on both sides: equal, not just close
        np.testing.assert_array_equal(port.conds.t3.speaker_emb.numpy(),
                                      np.asarray(jax_tts.conds.t3.speaker_emb))
    _assert_conds_close(port.conds, jax_tts.conds)
    assert port._cached_conditionals is port.conds


def test_profile_without_ve_embedding_raises(pair):
    _, port, paths, d = pair
    wav, sr = audio_io.load_audio(paths["ref16"])
    ts3gen.save_voice_profile(port.s3gen_params, wav, sr, str(d / "nove.npy"), CFG.s3gen)
    with pytest.raises(ValueError, match="missing ve_embedding"):
        port.prepare_conditionals_with_voice_profile(str(d / "nove.npy"))


def test_conditional_cache_hits_and_misses_match_jax(pair):
    jax_tts, port, paths, d = pair
    jax_tts.save_voice_profile(paths["ref16"], str(d / "cache.npy"))
    calls = [dict(audio_prompt_path=paths["ref16"]), dict(audio_prompt_path=paths["ref16"]),
             dict(audio_prompt_path=paths["ref16"], exaggeration=0.9),
             dict(voice_profile_path=str(d / "cache.npy")),
             dict(voice_profile_path=str(d / "cache.npy")),
             dict(audio_prompt_path=paths["ref16"])]
    for tts in (jax_tts, port):
        tts.clear_conditional_cache()
        tts._conditional_cache_hits = tts._conditional_cache_misses = 0
        outs = [tts._get_or_prepare_conditionals(**kw) for kw in calls]
        assert outs[0] is outs[1] and outs[3] is outs[4] and outs[0] is not outs[2]
    stats = port.get_conditional_cache_stats()
    assert stats == jax_tts.get_conditional_cache_stats()
    assert stats["hits"] == 2 and stats["misses"] == 4 and stats["cache_size"] == 1
    port.clear_conditional_cache()
    assert port.get_conditional_cache_stats()["cache_size"] == 0
    with pytest.raises(ValueError, match="Must provide one of"):
        port._get_or_prepare_conditionals(saved_voice_path="x.npy")


def test_generate_from_audio_prompt_matches_jax(pair):
    jax_tts, port, paths, _ = pair
    for tts in (jax_tts, port):
        tts.conds = None
        tts.clear_conditional_cache()
    jwav = jax_tts.generate(TEXT, audio_prompt_path=paths["ref24"], exaggeration=0.6, **GEN)
    wav = port.generate(TEXT, audio_prompt_path=paths["ref24"], exaggeration=0.6,
                        draws=JaxDraws(GEN["seed"]), **GEN)
    _assert_conds_close(port.conds, jax_tts.conds)
    n = port.perf["speech_tokens"]
    assert n >= 8 and wav.shape == jwav.shape == (1, 2 * n * 480)
    np.testing.assert_allclose(wav, jwav, atol=1e-3)
    # prepared conditionals are kept: another path is not read
    again = port.generate(TEXT, audio_prompt_path="/no/such/file.wav",
                          draws=JaxDraws(GEN["seed"]), **GEN)
    np.testing.assert_array_equal(again, wav)


def test_generate_from_voice_profile_matches_jax(pair):
    jax_tts, port, paths, d = pair
    jax_tts.save_voice_profile(paths["ref24"], str(d / "gen.npy"))
    for tts in (jax_tts, port):
        tts.conds = None
    jwav = jax_tts.generate(TEXT, voice_profile_path=str(d / "gen.npy"), **GEN)
    wav = port.generate(TEXT, voice_profile_path=str(d / "gen.npy"),
                        draws=JaxDraws(GEN["seed"]), **GEN)
    assert wav.shape == jwav.shape
    np.testing.assert_allclose(wav, jwav, atol=1e-3)


def test_generate_without_a_voice_raises_as_jax(pair):
    jax_tts, port, _, _ = pair
    for tts in (jax_tts, port):
        tts.conds = None
        with pytest.raises(RuntimeError, match="Conditionals are not prepared. Provide "
                                               "voice_profile_path"):
            tts.generate(TEXT)
    bare = ChatterboxTTS(port.t3_params, port.s3gen_params, port.tokenizer, config=CFG,
                         device="cpu")
    with pytest.raises(RuntimeError, match="needs the voice encoder"):
        bare.prepare_conditionals_with_audio_prompt("x.wav")


def test_wav_io_roundtrip_and_resampled_load(pair, tmp_path):
    _, _, paths, _ = pair
    from chatterbox_embed_tpu.utils import audio_io as jaudio
    for sr in (None, 16_000, 24_000):
        a, asr = audio_io.load_audio(paths["ref22"], sr=sr, device="cpu")
        b, bsr = jaudio.load_audio(paths["ref22"], sr=sr)
        assert asr == bsr and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=2e-5)
    x = voice(5, 0.2, 16_000)
    audio_io.save_audio(str(tmp_path / "x.wav"), x, 16_000)
    jaudio.save_audio(str(tmp_path / "y.wav"), x, 16_000)
    assert (tmp_path / "x.wav").read_bytes() == (tmp_path / "y.wav").read_bytes()
    with pytest.raises(RuntimeError, match="cannot decode"):
        if audio_io.ffmpeg_available():
            raise RuntimeError("cannot decode: ffmpeg present, branch not reachable here")
        audio_io.load_audio(str(tmp_path / "x.ogg"))
