"""The port's long-text path (tts.chunk_text, generate_chunks,
generate_chunks_multi, generate_long_text, generate_long_text_batch, the
retry pyramid, warmup) against the JAX package's, end to end at the tiny
config of tests/test_torch_tts.py: the JAX pipeline's random weights go
through weights.from_jax_params into the port, both read the same `.npy`
voice profiles, and the port draws JAX's own random numbers (`make_draws=
JaxDraws`: the pooled pass as generate_batch draws, each retry from seed +
1000 * attempt + chunk id).

Exact: chunk lists (story breaks included), per-chunk parameters, attempt
counts, stats keys and every segment's length (2 * tokens * 480, so the
tokens per chunk). Within 1e-3 absolute (the HiFT bound of
tests/test_torch_tts.py): every segment, the stitched wav and the
watermarked one. Also: the kill switch, a fault in the continuous engine,
that a CUDA or kernel error propagates instead of becoming silence, and
that warmup restores the conditional state."""
import dataclasses

import numpy as np
import pytest
import torch

from chatterbox_embed_tpu_torch import tts as ttts
from chatterbox_embed_tpu_torch.models import s3gen as ts3gen
from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer
from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
from chatterbox_embed_tpu_torch.weights import from_jax_params
from test_torch_tts import TINY
from torch_parity import JaxDraws

torch.set_num_threads(2)
STORY = ("The knight rode out at dawn. He crossed the river and the hills. "
         "⁂ A dragon slept in the cave. It woke up and smiled at him.")
OTHER = "A quiet morning by the sea. The waves rolled in slowly."
CHUNKS = dict(target_chars=30, max_chars=45)
GEN = dict(seed=1, max_new_tokens=24, **CHUNKS)
ATOL = 1e-3


def _profile(path, seed, n_prompt):
    """A voice profile (.npy) with an S3Gen prompt of `n_prompt` tokens and
    a T3 prompt of the config's 8."""
    rng = np.random.default_rng(seed)
    ts3gen.VoiceProfile(
        embedding=rng.standard_normal((1, 192)).astype(np.float32),
        prompt_feat=rng.standard_normal((1, 2 * n_prompt, 8)).astype(np.float32),
        prompt_token=rng.integers(0, 6561, (1, n_prompt)).astype(np.int64),
        prompt_token_len=np.array([n_prompt]),
        ve_embedding=rng.standard_normal((1, 256)).astype(np.float32)).save(path)
    return path


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    import chatterbox_embed_tpu.models.t3 as jt3
    import chatterbox_embed_tpu.tts as jtts
    mp = pytest.MonkeyPatch()
    # the JAX package's default buckets (another test file may narrow them)
    mp.setattr(jt3, "_TEXT_BUCKETS", (48, 96, 192, 384, 768))
    mp.setattr(jtts, "_TOKEN_BUCKETS", (128, 256, 512, 1024))
    mp.setenv("CHATTERBOX_PALLAS", "0")
    for key in ("CHATTERBOX_BATCH_CHUNKS", "CHATTERBOX_CONTINUOUS", "CHATTERBOX_ALIGNMENT",
                "CHATTERBOX_ENABLE_QUALITY_ANALYSIS", "CHATTERBOX_EXPERIMENT_MODE"):
        mp.delenv(key, raising=False)
    jax_tts = jtts.ChatterboxTTS.from_random(seed=0, config=TINY)
    state = from_jax_params(jax_tts.t3_params, jax_tts.s3gen_params, TINY)
    port = ChatterboxTTS(state["t3"], state["s3gen"], FallbackTokenizer(TINY.t3),
                         config=TINY, device="cpu")
    d = tmp_path_factory.mktemp("voices")
    voices = [_profile(str(d / "a.npy"), 21, 8), _profile(str(d / "b.npy"), 22, 10)]
    yield jax_tts, port, voices
    mp.undo()


def _fields(info):
    return dict(dataclasses.asdict(info), content_type=info.content_type.value)


def _assert_segments(segs, jsegs):
    assert len(segs) == len(jsegs)
    for s, j in zip(segs, jsegs):
        j = np.asarray(j)
        assert s.shape == j.shape and s.size > 0
        np.testing.assert_allclose(s, j, atol=ATOL)


def _assert_stats(stats, jstats):
    assert set(stats) == set(jstats)
    assert stats["batched_first_pass"] == jstats["batched_first_pass"]
    assert stats["regenerations"] == jstats["regenerations"]
    for c, jc in zip(stats["chunks"], jstats["chunks"], strict=True):
        assert (c["id"], c["attempts"], c["samples"]) == (jc["id"], jc["attempts"], jc["samples"])
        assert c["params"] == jc["params"]
    assert set(stats["perf"]) >= set(jstats["perf"])


@pytest.mark.parametrize("text", [STORY, OTHER, "Alpha part. ⁂ ⁂ Beta part.",
                                  "Part one ends here. ⁂", ""])
@pytest.mark.parametrize("sizes", [(30, 45), (400, 600)])
def test_chunk_text_matches_jax(pair, text, sizes):
    jax_tts, port, _ = pair
    got, want = port.chunk_text(text, *sizes), jax_tts.chunk_text(text, *sizes)
    assert [_fields(c) for c in got] == [_fields(c) for c in want]


def test_adaptive_chunk_params_match_jax(pair):
    jax_tts, port, _ = pair
    base = dict(exaggeration=0.5, cfg_weight=0.6, temperature=0.7, repetition_penalty=1.2,
                min_p=0.05, top_p=1.0)
    for blend in (0.0, 0.2, 1.0):
        assert port._adaptive_chunk_params(port.chunk_text(STORY, **CHUNKS), base, blend) == \
            jax_tts._adaptive_chunk_params(jax_tts.chunk_text(STORY, **CHUNKS), base, blend)


@pytest.mark.parametrize("alignment", ["0", "1"])
def test_generate_long_text_matches_jax(pair, monkeypatch, alignment):
    """One story of 4 chunks with a story break, pooled into one
    generate_batch; under CHATTERBOX_ALIGNMENT=1 the guard's forced EOS
    gives the chunks their own token counts."""
    jax_tts, port, (voice, _) = pair
    monkeypatch.setenv("CHATTERBOX_ALIGNMENT", alignment)
    calls = []
    orig = port.generate_batch
    monkeypatch.setattr(port, "generate_batch",
                        lambda texts, **kw: calls.append(len(texts)) or orig(texts, **kw))
    jwav, jmeta = jax_tts.generate_long_text(STORY, voice_profile_path=voice, **GEN)
    wav, meta = port.generate_long_text(STORY, voice_profile_path=voice, make_draws=JaxDraws,
                                        **GEN)
    assert calls == [4] and meta["num_chunks"] == jmeta["num_chunks"] == 4
    assert set(meta) == set(jmeta)
    _assert_stats(meta["chunk_stats"], jmeta["chunk_stats"])
    assert meta["chunk_stats"]["batched_first_pass"] is True
    assert meta["duration_s"] == jmeta["duration_s"]
    assert wav.shape == np.asarray(jwav).shape and np.abs(wav).max() <= 1.0
    np.testing.assert_allclose(wav, np.asarray(jwav), atol=ATOL)
    perf = meta["perf"]
    assert perf["requests"] == 4 and perf["speech_tokens"] * 960 == sum(
        c["samples"] for c in meta["chunk_stats"]["chunks"])
    if alignment == "1":
        tokens = [c["samples"] // 960 for c in meta["chunk_stats"]["chunks"]]
        assert min(tokens) < GEN["max_new_tokens"], tokens


def test_generate_chunks_segments_and_watermark_match_jax(pair):
    """The segments before stitching, the stitched wav, and the mark."""
    jax_tts, port, (voice, _) = pair
    chunks, jchunks = port.chunk_text(STORY, **CHUNKS), jax_tts.chunk_text(STORY, **CHUNKS)
    jsegs, jstats = jax_tts.generate_chunks(jchunks, voice_profile_path=voice, seed=4,
                                            max_new_tokens=20)
    segs, stats = port.generate_chunks(chunks, voice_profile_path=voice, seed=4,
                                       max_new_tokens=20, make_draws=JaxDraws)
    _assert_segments(segs, jsegs)
    _assert_stats(stats, jstats)
    wav, sr, dur = port.stitch_and_normalize(segs, chunks)
    jwav, jsr, jdur = jax_tts.stitch_and_normalize(jsegs, jchunks)
    assert (sr, dur) == (jsr, jdur)
    np.testing.assert_allclose(wav, jwav, atol=ATOL)
    marked = port.watermarker.apply_watermark(wav, sample_rate=sr)
    np.testing.assert_allclose(marked, jax_tts.watermarker.apply_watermark(jwav, sample_rate=sr),
                               atol=ATOL)


def test_generate_chunks_multi_pools_three_rows(pair, monkeypatch):
    """Two jobs with two voices: one pooled generate_batch of 3 rows with a
    voice per row, then each job's own stats."""
    jax_tts, port, (va, vb) = pair
    jobs = [(STORY[:63], va, 0.4), (OTHER[:27], vb, 0.7)]
    jc = [jax_tts._get_or_prepare_conditionals(voice_profile_path=v, exaggeration=e)
          for _, v, e in jobs]
    tc = [port._get_or_prepare_conditionals(voice_profile_path=v, exaggeration=e)
          for _, v, e in jobs]
    jchunks = [jax_tts.chunk_text(text, **CHUNKS) for text, _, _ in jobs]
    chunks = [port.chunk_text(text, **CHUNKS) for text, _, _ in jobs]
    assert [len(c) for c in chunks] == [2, 1]
    calls = []
    orig = port.generate_batch

    def spy(texts, **kw):
        calls.append((list(texts), kw["conds"]))
        return orig(texts, **kw)

    monkeypatch.setattr(port, "generate_batch", spy)
    params = [dict(exaggeration=e) for _, _, e in jobs]
    jout = jax_tts.generate_chunks_multi(jchunks, jc, jobs_params=params, max_new_tokens=16,
                                         seed=3)
    out = port.generate_chunks_multi(chunks, tc, jobs_params=params, max_new_tokens=16, seed=3,
                                     make_draws=JaxDraws)
    assert len(calls) == 1 and len(calls[0][0]) == 3
    assert calls[0][1][0] is tc[0] and calls[0][1][2] is tc[1]
    for (segs, stats), (jsegs, jstats) in zip(out, jout, strict=True):
        _assert_segments(segs, jsegs)
        _assert_stats(stats, jstats)
        assert stats["pooled_jobs"] == 2 and stats["pooled_rows"] == 3


def _silence(tts, silent_seeds, seeds):
    """Make `tts`'s pooled take of row 1 silent, and every retry whose seed
    is in `silent_seeds`; record the retry seeds in `seeds`."""
    batch, single = tts.generate_batch, tts._generate_with_prepared_conditionals

    def generate_batch(texts, **kw):
        wavs = list(batch(texts, **kw))
        wavs[1] = np.zeros_like(np.asarray(wavs[1]))
        return wavs

    def one(text, conds, **kw):
        seeds.append(kw["seed"])
        wav = single(text, conds, **kw)
        return np.zeros_like(np.asarray(wav)) if kw["seed"] in silent_seeds else wav

    return generate_batch, one


def test_silence_gate_retries_match_jax(pair, monkeypatch):
    """Chunk 1's pooled take and its first retry are silent: both packages
    retry with the same seeds (seed + 1000 * attempt + id) and drifted
    parameters, and accept the same second retry."""
    jax_tts, port, (voice, _) = pair
    seed = 5
    results = []
    for tts, kw in ((jax_tts, {}), (port, dict(make_draws=JaxDraws))):
        seeds = []
        b, one = _silence(tts, {seed + 1}, seeds)
        monkeypatch.setattr(tts, "generate_batch", b)
        monkeypatch.setattr(tts, "_generate_with_prepared_conditionals", one)
        segs, stats = tts.generate_chunks(tts.chunk_text(STORY, **CHUNKS),
                                          voice_profile_path=voice, seed=seed,
                                          max_new_tokens=16, **kw)
        results.append((segs, stats, seeds))
    (jsegs, jstats, jseeds), (segs, stats, seeds) = results
    assert seeds == jseeds == [seed + 1, seed + 1001]
    assert [c["attempts"] for c in stats["chunks"]] == [1, 3, 1, 1]
    assert stats["regenerations"] == 2
    _assert_stats(stats, jstats)
    _assert_segments(segs, jsegs)


def test_token_guard_failures_match_jax(pair):
    """Six tokens a chunk: every take fails the guard's 8 (the pooled one by
    its length), every retry raises TokenGuardError, and both packages
    fill the chunk with half a second of silence after 1 + 4 attempts."""
    jax_tts, port, (voice, _) = pair
    chunks = port.chunk_text(OTHER, **CHUNKS)
    segs, stats = port.generate_chunks(chunks, voice_profile_path=voice, seed=2,
                                       max_new_tokens=6, make_draws=JaxDraws)
    jsegs, jstats = jax_tts.generate_chunks(jax_tts.chunk_text(OTHER, **CHUNKS),
                                            voice_profile_path=voice, seed=2, max_new_tokens=6)
    _assert_stats(stats, jstats)
    assert [c["attempts"] for c in stats["chunks"]] == [5] * len(chunks)
    for s, j in zip(segs, jsegs, strict=True):
        np.testing.assert_array_equal(s, np.asarray(j))
        assert s.shape == (port.sr // 2,) and not s.any()
    assert issubclass(ttts.TokenGuardError, RuntimeError)


def test_batch_chunks_zero_runs_sequentially(pair, monkeypatch):
    jax_tts, port, (voice, _) = pair
    monkeypatch.setenv("CHATTERBOX_BATCH_CHUNKS", "0")
    monkeypatch.setattr(port, "generate_batch", lambda *a, **k: pytest.fail("pooled"))
    segs, stats = port.generate_chunks(port.chunk_text(STORY, **CHUNKS),
                                       voice_profile_path=voice, seed=7, max_new_tokens=16,
                                       make_draws=JaxDraws)
    jsegs, jstats = jax_tts.generate_chunks(jax_tts.chunk_text(STORY, **CHUNKS),
                                            voice_profile_path=voice, seed=7, max_new_tokens=16)
    assert stats["batched_first_pass"] is False
    _assert_stats(stats, jstats)
    _assert_segments(segs, jsegs)


def test_continuous_first_pass_raises(pair, monkeypatch):
    """CHATTERBOX_CONTINUOUS=1 runs the pooled pass on the continuous engine
    (tests/test_torch_continuous.py holds it to the JAX package's): an
    error inside the engine's decode raises, where the JAX package would
    fall back to the lock-step batch."""
    from chatterbox_embed_tpu_torch.models import t3_engine
    _, port, (voice, _) = pair
    monkeypatch.setenv("CHATTERBOX_CONTINUOUS", "1")

    def fault(*a, **k):
        raise RuntimeError("flash_decode kernel launch failed: cudaError 700")

    monkeypatch.setattr(t3_engine, "engine_decode_block", fault)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        port.generate_long_text(STORY, voice_profile_path=voice, make_draws=JaxDraws, **GEN)


def test_voices_that_cannot_pool_run_one_by_one(pair):
    """A voice without T3 prompt tokens beside one with them: the JAX
    package's multi-voice assert and the port's VoiceBatchError both send
    the chunks through the sequential pyramid, with equal results."""
    jax_tts, port, (va, vb) = pair
    jc = [jax_tts._get_or_prepare_conditionals(voice_profile_path=v) for v in (va, vb)]
    tc = [port._get_or_prepare_conditionals(voice_profile_path=v) for v in (va, vb)]
    jc[1] = jc[1].__class__(jc[1].t3._replace(cond_prompt_speech_tokens=None), jc[1].gen)
    tc[1] = tc[1].__class__(tc[1].t3._replace(cond_prompt_speech_tokens=None), tc[1].gen)
    jout = jax_tts.generate_chunks_multi([jax_tts.chunk_text(OTHER[:27]),
                                          jax_tts.chunk_text(STORY[:28])], jc,
                                         max_new_tokens=12, seed=8)
    out = port.generate_chunks_multi([port.chunk_text(OTHER[:27]), port.chunk_text(STORY[:28])],
                                     tc, max_new_tokens=12, seed=8, make_draws=JaxDraws)
    for (segs, stats), (jsegs, jstats) in zip(out, jout, strict=True):
        assert stats["batched_first_pass"] is False
        _assert_stats(stats, jstats)
        _assert_segments(segs, jsegs)


def test_generate_long_text_batch_matches_jax(pair, tmp_path):
    """Two stories with two voices and their own pause scales, one pooled
    decode; a job whose voice file is missing gets its error entry; the
    stitcher's pause scale is restored."""
    jax_tts, port, (va, vb) = pair
    texts = [STORY, OTHER, "Never read."]
    paths = [va, vb, str(tmp_path / "missing.npy")]
    kw = dict(pause_scales=[1.0, 1.6, 1.2], exaggeration=[0.5, 0.6, 0.5], **GEN)
    jres = jax_tts.generate_long_text_batch(texts, voice_profile_paths=paths, **kw)
    res = port.generate_long_text_batch(texts, voice_profile_paths=paths, make_draws=JaxDraws,
                                        **kw)
    assert port.advanced_stitcher.global_pause_factor == 1.2
    for (wav, meta), (jwav, jmeta) in zip(res[:2], jres[:2]):
        assert set(meta) == set(jmeta) and meta["batched_jobs"] == 2
        _assert_stats(meta["chunk_stats"], jmeta["chunk_stats"])
        assert meta["chunk_stats"]["pooled_jobs"] == 2
        assert wav.shape == np.asarray(jwav).shape
        np.testing.assert_allclose(wav, np.asarray(jwav), atol=ATOL)
    assert res[2][0] is None and jres[2][0] is None
    assert "missing.npy" in res[2][1]["error"]


KERNEL_FAULT = "flash_decode kernel launch failed: cudaError 700"


def _fault(*args, **kwargs):
    raise RuntimeError(KERNEL_FAULT)


@pytest.mark.parametrize("where", ["decode_attention", "t3.generate", "s3gen", "batch"])
def test_kernel_errors_propagate(pair, monkeypatch, where):
    """A CUDA or kernel error inside the pooled pass, a retry or a pooled
    batch of jobs is raised to the caller, never turned into a retry or
    half a second of silence."""
    from chatterbox_embed_tpu_torch.models import llama as tllama
    from chatterbox_embed_tpu_torch.models import t3 as tt3
    _, port, (voice, vb) = pair
    if where == "decode_attention":
        monkeypatch.setattr(tllama, "decode_attention", _fault)
    elif where == "t3.generate":
        monkeypatch.setenv("CHATTERBOX_BATCH_CHUNKS", "0")
        monkeypatch.setattr(tt3, "generate", _fault)
    elif where == "s3gen":
        monkeypatch.setattr(ts3gen, "token_to_wav", _fault)
    else:
        monkeypatch.setattr(tt3, "generate_batch", _fault)
        with pytest.raises(RuntimeError, match=KERNEL_FAULT):
            port.generate_long_text_batch([STORY, OTHER], voice_profile_paths=[voice, vb],
                                          make_draws=JaxDraws, **GEN)
        return
    with pytest.raises(RuntimeError, match=KERNEL_FAULT):
        port.generate_long_text(STORY, voice_profile_path=voice, make_draws=JaxDraws, **GEN)


@pytest.fixture(scope="module")
def random_tts():
    return ChatterboxTTS.from_random(seed=0, config=TINY, device="cpu")


def test_warmup_restores_conditional_state(random_tts, tmp_path):
    """With no voice prepared, warmup prepares one from a synthetic tone,
    runs every stage and restores the empty conditional state; with one
    prepared it keeps it."""
    tts = random_tts
    tts.conds = None
    tts.clear_conditional_cache()
    timings = tts.warmup(batch_sizes=(1, 2), max_new_tokens=12, token_buckets=(128,))
    assert set(timings) == {"conditionals_s", "batch1_s", "batch2_s", "tokens128_s"}
    assert all(v >= 0 for v in timings.values())
    assert tts.conds is None and tts._cached_conditionals is None and tts._cache_key is None
    prof = _profile(str(tmp_path / "v.npy"), 3, 8)
    conds = tts._get_or_prepare_conditionals(voice_profile_path=prof)
    key = tts._cache_key
    timings = tts.warmup(max_new_tokens=12, token_buckets=())
    assert set(timings) == {"batch1_s"}
    assert tts.conds is conds and tts._cached_conditionals is conds and tts._cache_key == key
