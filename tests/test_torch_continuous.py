"""The port's continuous serving (serving/continuous.py: ContinuousServer,
ContinuousStoryServer; tts._continuous_first_pass) against the JAX
package's, at the tiny pipeline of tests/test_torch_tts.py: the JAX
pipeline's random weights go through weights.from_jax_params into the port,
both get the same conditionals, and the port draws JAX's own random numbers
(`make_draws=JaxDraws`: each request's T3 steps, each vocode dispatch, a
streamed request's windows).

Exact: tokens per request (so each wav's length, 2 * tokens * 480), chunk
counts, attempts. Within 1e-3 absolute (the HiFT bound of
tests/test_torch_tts.py): each wav, each stitched and watermarked story, and
each chunk of `generate_long_text` under CHATTERBOX_CONTINUOUS=1.

Also the port's own properties of tests/test_continuous.py (a streamed
request equals `stream_generate`, also under traffic; pump-only buffers
freed; a failed vocode keeps its completions; nothing accumulates with
retain_*=False; the slot derivation), the bound on take_stream's record of
ids (the JAX package's grows with every id asked for, ROADMAP §3), and the
first pass's narrow catch: only the engine's refusal at submit falls back to
the lock-step batch; a fault inside the decode propagates."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chatterbox_embed_tpu.conditionals import Conditionals as JConditionals
from chatterbox_embed_tpu.models.t3 import T3Cond as JT3Cond
from chatterbox_embed_tpu.serving import continuous as jcont
from chatterbox_embed_tpu_torch.conditionals import Conditionals
from chatterbox_embed_tpu_torch.models import t3 as tt3
from chatterbox_embed_tpu_torch.models import t3_engine as teng
from chatterbox_embed_tpu_torch.models.t3 import T3Cond
from chatterbox_embed_tpu_torch.serving import continuous as tcont
from test_torch_tts import TINY
from torch_parity import JaxDraws, t, tiny_tts_pair

torch.set_num_threads(2)
ATOL = 1e-3
TEXTS = ["Hello world.", "A second test utterance.", "Third one."]
GEO = dict(slots=2, text_bucket=32, max_new_tokens=24, block=8, vocode_batch=2)
STORY = "The knight rode far. ⁂ The dragon was kind."


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    for key in ("CHATTERBOX_CONTINUOUS", "CHATTERBOX_ALIGNMENT", "CHATTERBOX_BATCH_CHUNKS",
                "CHATTERBOX_ENABLE_QUALITY_ANALYSIS", "CHATTERBOX_EXPERIMENT_MODE",
                "CHATTERBOX_PALLAS"):
        mp.delenv(key, raising=False)
    jax_tts, port = tiny_tts_pair(TINY, mp)
    yield jax_tts, port
    mp.undo()


def _second_voice(seed=29, n_prompt=12):
    """Another voice for both packages: a T3 prompt of the config's 8
    tokens, an S3Gen prompt of `n_prompt`."""
    rng = np.random.default_rng(seed)
    spk = rng.standard_normal((1, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (1, 8)).astype(np.int32)
    gen = dict(prompt_token=rng.integers(0, 6561, (1, n_prompt)).astype(np.int64),
               prompt_token_len=np.array([n_prompt]),
               prompt_feat=rng.standard_normal((1, 2 * n_prompt, 8)).astype(np.float32),
               prompt_feat_len=None,
               embedding=rng.standard_normal((1, 192)).astype(np.float32))
    return (JConditionals(JT3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5), gen),
            Conditionals(T3Cond(t(spk), t(prompt), 0.5), gen))


def _servers(pair, **kw):
    jax_tts, port = pair
    geo = dict(GEO, **kw)
    return (jcont.ContinuousServer(jax_tts, kv_int8=False, **geo),
            tcont.ContinuousServer(port, make_draws=JaxDraws, **geo))


def _assert_wavs(got, want):
    assert set(got) == set(want)
    for rid in want:
        w = np.asarray(want[rid])
        assert got[rid].shape == w.shape and w.size > 0 and w.size % (2 * 480) == 0
        np.testing.assert_allclose(got[rid], w, atol=ATOL)


def _serve(pair, texts, voices=None):
    """Both servers on the same traffic (two slots, so a refill happens
    mid-decode when there are more requests than slots); voices: per
    request (JAX, port) conditionals, or None for the prepared voice."""
    js, ts = _servers(pair)
    for i, text in enumerate(texts):
        kw = dict(seed=3 + i, cfg_weight=0.5, temperature=0.8)
        js.submit(text, conds=None if voices is None else voices[i][0], **kw)
        ts.submit(text, conds=None if voices is None else voices[i][1], **kw)
    jw, tw = js.drain(), ts.drain()
    assert not ts.failed and not js.failed
    _assert_wavs(tw, jw)
    assert (ts.decoder.blocks_run, ts.decoder.steps_run) == (js.decoder.blocks_run,
                                                             js.decoder.steps_run)
    return tw


def test_server_end_to_end_matches_jax(pair):
    tw = _serve(pair, TEXTS)
    assert len(tw) == 3 and all(np.isfinite(w).all() for w in tw.values())


def test_server_multi_voice_matches_jax(pair):
    """Two voices with S3Gen prompts of different lengths ride the
    multi-voice vocode bundle (ragged per-row prompts)."""
    jax_tts, port = pair
    first = (jax_tts.conds, port.conds)
    _serve(pair, ["Voice one speaking.", "Voice two speaking."], [first, _second_voice()])


def test_streamed_request_matches_stream_generate(pair):
    """submit(stream=True) at near-greedy temperature: the engine's tokens
    equal the lock-step stream's, so the chunks equal stream_generate's
    (same windows, same draws), the first before the request completes,
    and the completed wav is their concatenation."""
    _, port = pair
    text = "Hello streaming world."
    kw = dict(temperature=1e-4, cfg_weight=0.5)
    ref = np.concatenate(list(port.stream_generate(text, block_tokens=8, max_new_tokens=16,
                                                   seed=7, draws=JaxDraws(7), **kw)))
    srv = tcont.ContinuousServer(port, slots=2, text_bucket=32, max_new_tokens=16, block=8,
                                 vocode_batch=2, make_draws=JaxDraws)
    rid = srv.submit(text, stream=True, max_new_tokens=16, seed=7, **kw)
    chunks, finished, early = [], {}, False
    while not srv.idle:
        finished.update(srv.pump())
        new = srv.take_stream(rid)
        early |= bool(new) and rid not in finished
        chunks.extend(new)
    chunks.extend(srv.take_stream(rid))
    assert not srv.failed and early
    np.testing.assert_allclose(np.concatenate(chunks), ref, atol=1e-6)
    np.testing.assert_array_equal(finished[rid], np.concatenate(chunks))
    assert rid not in srv._schunks and not srv._stouched


def test_streamed_request_under_traffic(pair):
    """A streamed request's audio does not depend on the traffic around it."""
    _, port = pair

    def run(extra: int):
        srv = tcont.ContinuousServer(port, slots=2, text_bucket=32, max_new_tokens=16, block=8,
                                     vocode_batch=2)
        rid = srv.submit("Isolated stream target.", stream=True, temperature=0.7,
                         cfg_weight=0.5, seed=11, max_new_tokens=16)
        for i in range(extra):
            srv.submit(f"Background req {i}.", temperature=0.8, cfg_weight=0.5, seed=100 + i,
                       max_new_tokens=16)
        chunks = []
        while not srv.idle:
            srv.pump()
            chunks.extend(srv.take_stream(rid))
        chunks.extend(srv.take_stream(rid))
        return np.concatenate(chunks)

    np.testing.assert_array_equal(run(0), run(3))


def test_streamed_buffers_freed_for_pump_only_consumers(pair):
    _, port = pair
    srv = tcont.ContinuousServer(port, slots=2, text_bucket=32, max_new_tokens=16, block=8,
                                 vocode_batch=2)
    rid = srv.submit("Pump only consumer.", stream=True, seed=3, max_new_tokens=16)
    finished = {}
    while not srv.idle:
        finished.update(srv.pump())
    assert rid in finished and finished[rid].size > 0
    assert rid not in srv._schunks and rid not in srv._sdone
    assert srv.take_stream(rid) == []


def test_take_stream_records_only_streams_that_exist(pair):
    """Asking for ids that have no stream (never streamed, finished and
    released, or unknown) leaves nothing behind: a worker that runs forever
    holds state only for its live streams."""
    _, port = pair
    srv = tcont.ContinuousServer(port, slots=1, text_bucket=32, max_new_tokens=8, block=8)
    plain = srv.submit("Not streamed.", seed=1, max_new_tokens=8)
    for ext in [plain, 10 ** 6, -1] + list(range(100, 400)):
        assert srv.take_stream(ext) == []
    assert srv._stouched == set() and srv._schunks == {}
    streamed = srv.submit("Streamed.", stream=True, seed=2, max_new_tokens=8)
    assert srv.take_stream(streamed) == [] and srv._stouched == {streamed}
    srv.drain()
    srv.take_stream(streamed)        # the final take releases the stream
    assert srv._stouched == set() and srv._schunks == {} and srv._sdone == set()


def test_vocode_failure_preserves_completions(pair, monkeypatch):
    _, port = pair
    srv = tcont.ContinuousServer(port, slots=2, text_bucket=32, max_new_tokens=16, block=8,
                                 vocode_batch=1)
    rid = srv.submit("Hello there.", seed=7)
    real = type(port)._vocode_batch
    calls = {"n": 0}

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient OOM")
        return real(self, *a, **k)

    monkeypatch.setattr(type(port), "_vocode_batch", flaky)
    with pytest.raises(RuntimeError, match="transient OOM"):
        while True:
            srv.pump()
    assert srv._ready, "completed decode must survive the failed flush"
    wavs = srv.drain()
    assert rid in wavs and np.isfinite(wavs[rid]).all() and calls["n"] == 2


def test_slot_derivation_follows_the_fence(pair, monkeypatch):
    """slots=None: t3.max_decode_utterances at the engine's capacity, in
    the compute dtype, against the device's free bytes: 16 without a
    fence (the CPU), 4 when the free bytes hold 4 CFG slots' cache; with
    kv_int8=True the same bytes hold 8 (int8 slabs and their fp32 scales:
    (16 + 4) bytes a head-row against fp32's 64)."""
    _, port = pair
    cfg = port.cfg.t3
    bucket, cap = 32, 16
    srv = tcont.ContinuousServer(port, text_bucket=bucket, max_new_tokens=cap, block=8)
    assert srv.decoder.slots == 16
    _, capacity = teng.engine_geometry(cfg, bucket, 2 + cfg.perceiver_num_queries, cap)
    lc = cfg.llama
    per_tok = lc.num_layers * 2 * lc.num_kv_heads * lc.head_dim * 4      # fp32 cache
    free = int(4 * 2 * capacity * per_tok / tt3.KV_FENCE_FRACTION)
    monkeypatch.setattr(tt3, "free_device_bytes", lambda device: free)
    srv = tcont.ContinuousServer(port, text_bucket=bucket, max_new_tokens=cap, block=8)
    assert srv.decoder.slots == 4
    srv = tcont.ContinuousServer(port, text_bucket=bucket, max_new_tokens=cap, block=8,
                                 kv_int8=True)
    assert srv.decoder.slots == 8 and srv.decoder.kv_int8


def _stories(pair, **kw):
    jax_tts, port = pair
    geo = dict(slots=2, text_bucket=32, max_new_tokens=24, block=8, vocode_batch=2, **kw)
    return (jcont.ContinuousStoryServer(jax_tts, **geo),
            tcont.ContinuousStoryServer(port, make_draws=JaxDraws, **geo))


def _assert_story(got, want):
    (wav, meta), (jwav, jmeta) = got, want
    jwav = np.asarray(jwav)
    assert wav.shape == jwav.shape and wav.ndim == 2 and np.isfinite(wav).all()
    np.testing.assert_allclose(wav, jwav, atol=ATOL)
    assert meta["num_chunks"] == jmeta["num_chunks"]
    assert meta["chunk_stats"]["continuous"] is True
    assert meta["chunk_stats"]["regenerations"] == jmeta["chunk_stats"]["regenerations"]
    for c, jc in zip(meta["chunk_stats"]["chunks"], jmeta["chunk_stats"]["chunks"],
                     strict=True):
        assert (c["id"], c["attempts"], c["samples"]) == (jc["id"], jc["attempts"],
                                                           jc["samples"])
    assert meta["engine"] == jmeta["engine"]


def test_story_server_end_to_end_matches_jax(pair):
    """Two stories interleaved on one engine (a story break makes the first
    two chunks): stitched, watermarked wavs and metadata as the JAX
    server's."""
    jax_tts, port = pair
    jsrv, tsrv = _stories(pair)
    jids = [jsrv.submit_story(STORY, jax_tts.conds, seed=1),
            jsrv.submit_story("A quiet morning by the sea.", jax_tts.conds, seed=2)]
    tids = [tsrv.submit_story(STORY, port.conds, seed=1),
            tsrv.submit_story("A quiet morning by the sea.", port.conds, seed=2)]
    jout, tout = jsrv.drain(), tsrv.drain()
    assert tsrv.idle and set(tout) == set(tids)
    for a, b in zip(tids, jids):
        _assert_story(tout[a], jout[b])
    assert tout[tids[0]][1]["num_chunks"] == 2
    # the story server owns result lifetimes: nothing accumulates below it
    assert tsrv.srv._wavs == {} and tsrv.srv.decoder._results == {}
    assert tsrv.srv._ready == [] and tsrv._jobs == {} and tsrv._rid_map == {}


def test_story_server_retry_reenters_engine(pair, monkeypatch):
    """A chunk that fails its gate re-enters the engine with the retry
    drift and seed + 1000 * attempt + id; QA exhaustion keeps the last take
    (both packages, the same takes)."""
    jax_tts, port = pair
    for tts in pair:
        monkeypatch.setattr(tts, "_chunk_gates_ok", lambda flat, info: (False, "qa"))
    jsrv, tsrv = _stories(pair, max_attempts=2)
    jid = jsrv.submit_story("A single short chunk.", jax_tts.conds, seed=4)
    tid = tsrv.submit_story("A single short chunk.", port.conds, seed=4)
    jout, tout = jsrv.drain(), tsrv.drain()
    _assert_story(tout[tid], jout[jid])
    meta = tout[tid][1]
    assert meta["chunk_stats"]["chunks"][0]["attempts"] == 2
    assert meta["chunk_stats"]["regenerations"] == 1


def test_story_server_rejects_oversized_chunks(pair):
    _, port = pair
    srv = tcont.ContinuousStoryServer(port, slots=1, text_bucket=8, max_new_tokens=8, block=4)
    with pytest.raises(ValueError, match="bucket"):
        srv.submit_story("This sentence is very much longer than an eight token engine "
                         "bucket could ever hold at once.", port.conds)
    assert srv.idle and not srv._rid_map and not srv.srv.decoder._queue


# -- the long-text first pass on the engine ---------------------------------

LONG = ("The knight rode out at dawn. He crossed the river and the hills. "
        "⁂ A dragon slept in the cave. It woke up and smiled at him.")
LONG_KW = dict(target_chars=30, max_chars=45, max_new_tokens=24, seed=1)


@pytest.fixture
def voice(pair, tmp_path):
    from test_torch_long_text import _profile
    return _profile(str(tmp_path / "v.npy"), 21, 8)


def test_generate_long_text_continuous_matches_jax(pair, voice, monkeypatch):
    """CHATTERBOX_CONTINUOUS=1: the pooled first pass runs on the engine in
    both packages, chunk for chunk (row r samples from seed + r)."""
    jax_tts, port = pair
    monkeypatch.setenv("CHATTERBOX_CONTINUOUS", "1")
    calls = []
    real = tcont.ContinuousServer.drain
    monkeypatch.setattr(tcont.ContinuousServer, "drain",
                        lambda self: calls.append(self.decoder.slots) or real(self))
    jwav, jmeta = jax_tts.generate_long_text(LONG, voice_profile_path=voice, **LONG_KW)
    wav, meta = port.generate_long_text(LONG, voice_profile_path=voice, make_draws=JaxDraws,
                                        **LONG_KW)
    assert calls == [4] and meta["num_chunks"] == jmeta["num_chunks"] == 4
    stats, jstats = meta["chunk_stats"], jmeta["chunk_stats"]
    assert stats["batched_first_pass"] and jstats["batched_first_pass"]
    for c, jc in zip(stats["chunks"], jstats["chunks"], strict=True):
        assert (c["id"], c["attempts"], c["samples"]) == (jc["id"], jc["attempts"],
                                                           jc["samples"])
    np.testing.assert_allclose(wav, np.asarray(jwav), atol=ATOL)


def test_first_pass_falls_back_only_on_a_refusal(pair, monkeypatch):
    """A cond the engine refuses at submit (no prompt tokens) runs the
    lock-step batch; an error inside the engine's decode propagates."""
    _, port = pair
    monkeypatch.setenv("CHATTERBOX_CONTINUOUS", "1")
    p = dict(temperature=0.7, cfg_weight=0.5, repetition_penalty=1.2, min_p=0.05, top_p=1.0,
             exaggeration=0.5)
    texts = ["Hello there.", "Another chunk."]
    promptless = Conditionals(port.conds.t3._replace(cond_prompt_speech_tokens=None),
                              port.conds.gen)
    batch = []
    real = port.generate_batch
    monkeypatch.setattr(port, "generate_batch",
                        lambda texts, **kw: batch.append(len(texts)) or real(texts, **kw))
    out = port._batched_first_pass(texts, [dict(p)] * 2, promptless, 12, 0)
    assert batch == [2] and set(out) == {0, 1}

    def fault(*a, **k):
        raise RuntimeError("flash_decode kernel launch failed: cudaError 700")

    monkeypatch.setattr(teng, "engine_decode_block", fault)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        port._batched_first_pass(texts, [dict(p)] * 2, port.conds, 12, 0)
    assert batch == [2]
