"""The port's own copies of the JAX package's jax-free long-text helpers
against the originals, on the same inputs: the sanitiser (`deep_clean`,
on the texts of tests/test_pipeline.py's sanitiser tests and a hypothesis
corpus), the smart chunker (field by field), the adaptive parameters, the
quality analyzer (scores, issues, should_regenerate, in every QA mode), the
stitcher (bit-equal wavs) and the alignment analyzer. Exact equality
throughout: the copies are the same code."""
import dataclasses

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from chatterbox_embed_tpu.chunking import smart_chunker as jchunker
from chatterbox_embed_tpu.chunking import types as jtypes
from chatterbox_embed_tpu.models import alignment as jalign
from chatterbox_embed_tpu.parameters import adaptive as jadaptive
from chatterbox_embed_tpu.quality import analyzer as janalyzer
from chatterbox_embed_tpu.stitching import stitcher as jstitcher
from chatterbox_embed_tpu.text import sanitizer as jsanitizer
from chatterbox_embed_tpu_torch.chunking import smart_chunker as tchunker
from chatterbox_embed_tpu_torch.chunking import types as ttypes
from chatterbox_embed_tpu_torch.models import alignment as talign
from chatterbox_embed_tpu_torch.parameters import adaptive as tadaptive
from chatterbox_embed_tpu_torch.quality import analyzer as tanalyzer
from chatterbox_embed_tpu_torch.stitching import stitcher as tstitcher
from chatterbox_embed_tpu_torch.text import STORY_BREAK_TOKEN, AdvancedTextSanitizer
from chatterbox_embed_tpu_torch.utils import audio_io

SR = 24_000
# the inputs of tests/test_pipeline.py's sanitiser tests, and a few more
TEXTS = [
    "Visit https://example.com/page for **info**! It costs $5.50 at 3:45pm, 25°C.",
    "Chapter one ⁂ Chapter two",
    "Released on 2026-01-22, it was new.",
    "Update to v2.1.3 now.",
    "Build 10.4.1.2 shipped.",
    "Call 555-867-5309 today.",
    "On 2026-01-22 we sold 42 units of v2.1.3.",
    "Pages 5-10 of the 1984 edition, rated 3.5.",
    "Don't touch John's book of rock'n'roll.",
    "the boys' room",
    "Einstein wrote E=mc^2 on the board.",
    "Einstein wrote E=mc^{2} on the board.",
    "Let x_1=3.14 here.",
    "We know a*b=c.",
    "Set x=-2 for this.",
    "A well-known path, 5-10 pages.",
    "",
    "   \n\t ",
    "hello world",
    "ends with exclaim!",
    "is this a question?",
    "the café was nice \U0001f600 really",
    "Part one ends here. ⁂",
    "part one ⁂ part two",
    "Wait… what: really;",
    'The hero said "hello there, friend!" Then suddenly, meanwhile, the castle shook.',
    "Dr. Smith met Mr. Jones at 10:30am on Jan. 5th; they paid €1,250.75 (approx.).",
    "# Title\n\n* item one\n* item two\n\n> a quote, with `code` and [a link](http://x.y)",
]
STORY = ("Once upon a time there was a brave knight. He rode across the land, "
         "far and wide, until the sun went down. Then he found a dragon!\n\n"
         '"Who goes there?" asked the dragon. "A friend," said the knight. ⁂ '
         "The dragon was friendly, however, and they became the best of friends; "
         "they travelled together for many years, visiting 12 kingdoms.")
CHUNK_SIZES = [(40, 58), (120, 180), (400, 600)]


def _fields(info):
    d = dataclasses.asdict(info)
    d["content_type"] = info.content_type.value
    return d


def _jax_info(info):
    """The port's ChunkInfo as the JAX package's."""
    return jtypes.ChunkInfo(**dict(dataclasses.asdict(info),
                                   content_type=jtypes.ContentType(info.content_type.value)))


@pytest.mark.parametrize("text", TEXTS)
def test_deep_clean_matches_jax(text):
    assert AdvancedTextSanitizer().deep_clean(text) == \
        jsanitizer.AdvancedTextSanitizer().deep_clean(text)


@settings(max_examples=150, deadline=None)
@given(st.text(alphabet=st.sampled_from(
    list("abcXYZ .,;:!?'\"-()$%&*/=^_0123456789\n\t") + ["⁂", "é", "ü", "…", "—", "°"]),
    max_size=80))
def test_deep_clean_matches_jax_on_generated_text(text):
    assert AdvancedTextSanitizer().deep_clean(text) == \
        jsanitizer.AdvancedTextSanitizer().deep_clean(text)


def test_sanitizer_language_check_and_break_token():
    assert STORY_BREAK_TOKEN == jsanitizer.STORY_BREAK_TOKEN
    for text, lang in (("héllo", "en"), ("hällo", "de"), ("hello", "en")):
        assert AdvancedTextSanitizer().validate_text_for_language(text, lang) == \
            jsanitizer.AdvancedTextSanitizer().validate_text_for_language(text, lang)


@pytest.mark.parametrize("target,max_chars", CHUNK_SIZES)
@pytest.mark.parametrize("text", [STORY, TEXTS[0], TEXTS[25], TEXTS[27], "One.", ""])
def test_smart_chunk_matches_jax(text, target, max_chars):
    clean = jsanitizer.AdvancedTextSanitizer().deep_clean(text)
    for segment in clean.split(STORY_BREAK_TOKEN):
        got = tchunker.SmartChunker().smart_chunk(segment, target, max_chars)
        want = jchunker.SmartChunker().smart_chunk(segment, target, max_chars)
        assert [_fields(c) for c in got] == [_fields(c) for c in want]
        assert all(isinstance(c.content_type, ttypes.ContentType) for c in got)


@pytest.mark.parametrize("target,max_chars", CHUNK_SIZES)
def test_adaptive_parameters_match_jax(target, max_chars):
    clean = jsanitizer.AdvancedTextSanitizer().deep_clean(STORY + " " + TEXTS[25])
    chunks = tchunker.SmartChunker().smart_chunk(clean, target, max_chars)
    assert len(chunks) >= 1
    for c in chunks:
        jc = _jax_info(c)
        assert tadaptive.AdaptiveParameterManager().get_adaptive_parameters(c) == \
            jadaptive.AdaptiveParameterManager().get_adaptive_parameters(jc)


def _signals():
    rng = np.random.default_rng(0)
    t = np.arange(3 * SR) / SR
    tone = (0.4 * np.sin(2 * np.pi * 180 * t)).astype(np.float32)
    gated = tone * (np.sin(2 * np.pi * 0.4 * t) > 0)
    return {
        "speech_like": np.clip(0.15 * rng.standard_normal(3 * SR), -0.5, 0.5).astype(np.float32),
        "silent": np.zeros(3 * SR, np.float32),
        "quiet": (1e-3 * tone).astype(np.float32),
        "loud": np.clip(2.0 * tone, -1, 1).astype(np.float32),
        "gated": gated.astype(np.float32),
        "short": tone[: SR // 10],
        "long_silence_end": np.concatenate([tone[:SR], np.zeros(2 * SR, np.float32)]),
    }


@pytest.mark.parametrize("mode", ["silence_only", "broad", "off", "bogus"])
@pytest.mark.parametrize("name", list(_signals()))
def test_quality_analyzer_matches_jax(monkeypatch, mode, name):
    monkeypatch.setenv("CHATTERBOX_QA_REGEN_MODE", mode)
    audio = _signals()[name]
    info = ttypes.ChunkInfo(0, "hello world this is a chunk of text", ttypes.ContentType.NARRATIVE,
                            36, 8, True, False, ".", False, 0.0, 2.0)
    jinfo = _jax_info(info)
    got = tanalyzer.ChunkQualityAnalyzer().analyze_chunk_quality(audio, SR, info)
    want = janalyzer.ChunkQualityAnalyzer().analyze_chunk_quality(audio, SR, jinfo)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("pause", [0.5, 1.2, 2.5])
def test_advanced_stitch_matches_jax_bit_for_bit(tmp_path, pause):
    rng = np.random.default_rng(1)
    clean = jsanitizer.AdvancedTextSanitizer().deep_clean(STORY)
    chunks = tchunker.SmartChunker().smart_chunk(clean, 40, 58)
    chunks[1].has_story_break = True
    chunks[-1].is_last_chunk = True
    segs = [(0.3 * rng.standard_normal(int(SR * (0.4 + 0.2 * i)))).astype(np.float32)
            for i in range(len(chunks))]
    jchunks = [_jax_info(c) for c in chunks]
    ts, js = tstitcher.AdvancedStitcher(SR), jstitcher.AdvancedStitcher(SR)
    ts.global_pause_factor = js.global_pause_factor = pause
    wav, sr, dur = ts.advanced_stitch(segs, chunks, str(tmp_path / "port.wav"))
    jwav, jsr, jdur = js.advanced_stitch(segs, jchunks, str(tmp_path / "jax.wav"))
    np.testing.assert_array_equal(wav, jwav)
    assert (sr, dur) == (jsr, jdur)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    np.testing.assert_array_equal(ts.fallback_stitch(segs, 300), js.fallback_stitch(segs, 300))


def test_stitcher_shares_the_wav_reader_and_writer(tmp_path):
    """One copy of the wav I/O in the port: the stitcher's names are
    utils/audio_io's, and they read back what the JAX package writes."""
    assert tstitcher.write_wav is audio_io.write_wav and tstitcher.read_wav is audio_io.read_wav
    x = np.linspace(-1, 1, 999, dtype=np.float32)
    jstitcher.write_wav(str(tmp_path / "a.wav"), x, SR)
    a, sr = audio_io.read_wav(str(tmp_path / "a.wav"))
    b, jsr = jstitcher.read_wav(str(tmp_path / "a.wav"))
    np.testing.assert_array_equal(a, b)
    assert sr == jsr == SR


def test_alignment_analyzer_matches_jax():
    rng = np.random.default_rng(2)
    ta, ja = talign.AlignmentStreamAnalyzer(12), jalign.AlignmentStreamAnalyzer(12)
    for step in range(30):
        row = rng.random(12)
        row[min(11, step // 2)] += 2.0 if step % 7 else 0.0
        rt, rj = ta.step(row), ja.step(row)
        assert dataclasses.asdict(rt) == dataclasses.asdict(rj)
        logits = rng.standard_normal(6563).astype(np.float32)
        np.testing.assert_array_equal(ta.bias_logits(logits, rt), ja.bias_logits(logits, rj))
