"""The port's serving worker and jobs (serving/worker.py, jobs.py,
storage.py, utils/misc.py, audio_io.wav_to_mp3_bytes) and the clone
pipeline (vc.create_voice_clone, clone_voice), with the JAX package's test
fakes (tests/test_pipeline.py): `InMemoryStreams` for Redis, the local
storage emulation under a temporary CHATTERBOX_LOCAL_STORAGE for R2 and
Firestore, a fake and a tiny real ChatterboxTTS. No server, no network.

- The copies are held to the originals: the same outputs on the same
  inputs, the same files written.
- The worker: run_once with and without WORKER_MAX_BATCH, run_continuous to
  a drained stream (every status `done`, audio stored, metadata
  `continuous`), the VC mode, the DLQ, the intake fallback, a failing pump
  failing its jobs, the profile cache keyed on the bucket, continuous
  serving the default; without a factory the worker loads
  ChatterboxTTS.from_pretrained / ChatterboxVC.from_pretrained (the hub a
  stand-in module here); where the port differs on purpose, a malformed
  WORKER_MESH raises (a valid WORKER_MESH serves on a mesh:
  tests/test_torch_parallel.py).
- The clone pipeline against the JAX package's on the same audio: the same
  result keys, storage keys, stored profile fields and Firestore fields."""
import base64
import json
import pathlib

import numpy as np
import pytest
import torch

from chatterbox_embed_tpu.serving import jobs as jjobs
from chatterbox_embed_tpu.serving import storage as jstorage
from chatterbox_embed_tpu.serving import worker as jworker
from chatterbox_embed_tpu.utils import audio_io as jaudio
from chatterbox_embed_tpu.utils import misc as jmisc
from chatterbox_embed_tpu_torch.serving import jobs as tjobs
from chatterbox_embed_tpu_torch.serving import storage as tstorage
from chatterbox_embed_tpu_torch.serving import worker as tworker
from chatterbox_embed_tpu_torch.serving.worker import (DLQ_STREAM, STREAM_TTS, STREAM_VC,
                                                       InMemoryStreams, RedisWorker)
from chatterbox_embed_tpu_torch.utils import audio_io as taudio
from chatterbox_embed_tpu_torch.utils import misc as tmisc
from test_torch_long_text import _profile
from test_torch_tts import TINY

torch.set_num_threads(2)


@pytest.fixture
def store(tmp_path, monkeypatch):
    root = tmp_path / "store"
    monkeypatch.setenv("CHATTERBOX_LOCAL_STORAGE", str(root))
    for key in ("WORKER_MESH", "WORKER_MAX_BATCH", "WORKER_CONTINUOUS", "WORKER_WARMUP",
                "R2_ACCOUNT_ID", "R2_ENDPOINT", "CHATTERBOX_ENABLE_DIRECT_FIRESTORE_UPDATE"):
        monkeypatch.delenv(key, raising=False)
    return root


# -- the copies held to the originals ----------------------------------------

NAMES = ["Alice's Voice #2", "", "___", "Ünïcode Náme", "a--b  c", "UPPER lower 123"]


@pytest.mark.parametrize("name", NAMES)
def test_storage_helpers_equal_the_originals(name):
    assert tstorage.voice_id_slug(name) == jstorage.voice_id_slug(name)
    for bucket in (None, "", "minstraly-storage", "r2://b", "other", name):
        assert tstorage.is_r2_bucket(bucket) == jstorage.is_r2_bucket(bucket)
        assert tstorage.resolve_bucket_name(bucket) == jstorage.resolve_bucket_name(bucket)
    meta = {"story_id": name, "n": 3, "plain": "ascii"}
    assert tstorage._ascii_metadata(meta) == jstorage._ascii_metadata(meta)


def test_storage_local_emulation_equals_the_original(store, monkeypatch):
    """Both packages write the same object at the same path, read it back,
    and keep the same Firestore documents."""
    data = b"\x00\x01payload" * 7
    urls = [m.upload_to_r2(data, f"private/{i}/x.bin", "r2://bkt", metadata={"k": "v"})
            for i, m in enumerate((jstorage, tstorage))]
    assert [pathlib.Path(u).relative_to(store).parts[1:] for u in urls] == [
        ("private", str(i), "x.bin") for i in range(2)]
    for i, m in enumerate((tstorage, jstorage)):
        assert m.download_from_r2(f"private/{1 - i}/x.bin", "r2://bkt") == data
    docs = []
    for i, m in enumerate((jstorage, tstorage)):
        doc = m.init_firestore_client().collection(f"c{i}").document("d")
        doc.set({"a": 1, "b": [1, 2]})
        doc.update({"b": "x"}, merge=True)
        snap = doc.get()
        docs.append((snap.exists, snap.to_dict()))
    assert docs[0] == docs[1] == (True, {"a": 1, "b": "x"})


def test_misc_equals_the_original():
    assert tmisc.REPO_ID == jmisc.REPO_ID
    assert tmisc.ffmpeg_available() == jmisc.ffmpeg_available()
    for x in (np.zeros(0), np.zeros(4), np.array([0.5, -0.25]), np.linspace(-2, 2, 101)):
        assert tmisc.peak_db(x) == jmisc.peak_db(x)
        assert tmisc.rms_db(x) == jmisc.rms_db(x)
    d = tmisc.AttrDict(a=1)
    d.b = 2
    assert d == jmisc.AttrDict(a=1, b=2) and d.a == 1
    assert tmisc.get_git_sha() == jmisc.get_git_sha()


@pytest.mark.parametrize("peak", [0.2, 1.0, 3.0])
def test_wav_to_mp3_bytes_equals_the_original(peak):
    wav = (peak * np.sin(np.linspace(0, 200, 4800))).astype(np.float32)
    assert taudio.wav_to_mp3_bytes(wav, 24_000) == jaudio.wav_to_mp3_bytes(wav, 24_000)


@pytest.mark.parametrize("args", [
    ("user", "", "vid", None, None), ("app", "Name", "vid", {"story_type": "bad"}, True),
    ("other", "", "", {"voice_name": "From meta"}, False), ("user", "N", "v", {}, None)])
def test_job_helpers_equal_the_originals(args, monkeypatch):
    monkeypatch.delenv("CHATTERBOX_ENABLE_DIRECT_FIRESTORE_UPDATE", raising=False)
    assert tjobs._normalize_story_fields(*args) == jjobs._normalize_story_fields(*args)


def test_fetch_profile_equals_the_original(store):
    blob = b"profile-bytes" * 5
    tstorage.upload_to_r2(blob, "voices/p.npy", None)
    for args in ((base64.b64encode(blob).decode(), None, None), (None, "voices/p.npy", None)):
        paths = [m._fetch_profile(*args) for m in (tjobs, jjobs)]
        assert [pathlib.Path(p).read_bytes() for p in paths] == [blob, blob]
        for p in paths:
            pathlib.Path(p).unlink()
    for m in (tjobs, jjobs):
        with pytest.raises(ValueError, match="need voice_profile_b64"):
            m._fetch_profile(None, None, None)


def test_streams_and_payloads_equal_the_originals():
    """The in-memory stream backend and the payload parser give the same
    deliveries, acks and hashes (message ids carry a clock: compared by
    order)."""
    results = []
    for m in (jworker, tworker):
        c = m.InMemoryStreams()
        for i in range(5):
            c.xadd("s", {"payload": json.dumps({"i": i})})
        got = [c.xreadgroup("g", "a", {"s": ">"}, count=2) for _ in range(4)]
        c.xack("s", "g", got[0][0][1][0][0])
        c.hset("h", {"x": "1"})
        c.hset("h", {"y": "2"})
        results.append(([[f for _, f in es] for r in got for _, es in r],
                        len(c.acked[("s", "g")]), c.hgetall("h"),
                        m.RedisWorker.parse_payload({"payload:a": "1", "payload:b": "x",
                                                     "other": "z"}),
                        m.RedisWorker.parse_payload({"payload": '{"q": [1]}'}),
                        (m.STREAM_TTS, m.STREAM_VC, m.DLQ_STREAM)))
    assert results[0] == results[1]


# -- the worker -----------------------------------------------------------------

class FakeTTS:
    sr = 24_000

    def __init__(self):
        self.calls = []

    def generate_tts_story(self, **kw):
        self.calls.append(kw)
        return {"status": "success", **kw}


def _job(client, job_id, stream=STREAM_TTS, **payload):
    client.xadd(stream, {"payload": json.dumps({"job_id": job_id, "type": "tts", **payload})})


def test_run_once_one_job_with_a_fake(store):
    client, fake = InMemoryStreams(), FakeTTS()
    worker = RedisWorker(mode="tts", client=client, tts_factory=lambda: fake)
    _job(client, "j1", story_id="s1", user_id="u1", text="hi", voice_profile_b64="AAA=")
    assert worker.run_once() == 1
    assert fake.calls[0]["story_id"] == "s1"
    assert client.hgetall("runpod:job:j1")["status"] == "done"


def test_dlq(store):
    class BoomTTS:
        def generate_tts_story(self, **kw):
            raise RuntimeError("boom")

    client = InMemoryStreams()
    worker = RedisWorker(mode="tts", client=client, tts_factory=BoomTTS)
    _job(client, "j2", text="hi")
    worker.run_once()
    assert client.hgetall("runpod:job:j2")["status"] == "error"
    assert len(client.streams[DLQ_STREAM]) == 1


def test_vc_mode(store):
    calls = {}

    class FakeVC:
        sr = 24_000

        def create_voice_clone(self, audio_path, voice_id, voice_name, user_id=None,
                               language="en", bucket=None, metadata=None):
            calls.update(voice_id=voice_id, voice_name=voice_name, user_id=user_id)
            return {"status": "success", "voice_id": voice_id}

    client = InMemoryStreams()
    worker = RedisWorker(mode="vc", client=client, vc_factory=FakeVC)
    _job(client, "v1", stream=STREAM_VC, type="vc", voice_id="vid9", voice_name="Nine",
         user_id="u7", audio_b64=base64.b64encode(b"RIFF0000WAVEfmt ").decode())
    assert worker.run_once() == 1
    assert calls == dict(voice_id="vid9", voice_name="Nine", user_id="u7")
    status = client.hgetall("runpod:job:v1")
    assert status["status"] == "done" and "vid9" in status["result"]


def test_continuous_serving_is_the_default(monkeypatch):
    monkeypatch.delenv("WORKER_CONTINUOUS", raising=False)
    assert RedisWorker.continuous_enabled() is True
    monkeypatch.setenv("WORKER_CONTINUOUS", "0")
    assert RedisWorker.continuous_enabled() is False


def test_worker_mesh_and_missing_factories_raise(store, monkeypatch, tmp_path):
    """A malformed WORKER_MESH raises when the worker is built. Without a
    factory the worker loads the model as the JAX worker does:
    ChatterboxTTS.from_pretrained / ChatterboxVC.from_pretrained, which
    download the checkpoint's five files (a stand-in hub module here) and
    load their folder on the card (from_local stubbed here to record its
    call and hand back a fake); without huggingface_hub that raises."""
    import sys
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    from chatterbox_embed_tpu_torch.vc import ChatterboxVC
    from test_torch_tts import CHECKPOINT_FILES, StandInHub
    monkeypatch.setenv("WORKER_MESH", "2by2")
    with pytest.raises(ValueError, match="WORKER_MESH"):
        RedisWorker(mode="tts", client=InMemoryStreams(), tts_factory=FakeTTS)
    monkeypatch.delenv("WORKER_MESH")
    hub = StandInHub(tmp_path)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module)
    loads = []
    for cls in (ChatterboxTTS, ChatterboxVC):
        monkeypatch.setattr(cls, "from_local", classmethod(
            lambda c, folder, **kw: loads.append((c.__name__, folder, kw)) or FakeTTS()))
    client = InMemoryStreams()
    worker = RedisWorker(mode="tts", client=client)
    tts = worker._get_tts()
    assert isinstance(tts, FakeTTS) and worker._get_tts() is tts
    vc = RedisWorker(mode="vc", client=InMemoryStreams())._get_vc()
    assert isinstance(vc, FakeTTS)
    assert hub.asked == [("ResembleAI/chatterbox", f) for f in CHECKPOINT_FILES] * 2
    assert loads == [(name, tmp_path, {"device": None})
                     for name in ("ChatterboxTTS", "ChatterboxVC")]
    _job(client, "j1", story_id="s1", user_id="u1", text="hi", voice_profile_b64="AAA=")
    assert worker.run_once() == 1 and tts.calls[0]["story_id"] == "s1"
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface_hub unavailable"):
        RedisWorker(mode="tts", client=InMemoryStreams())._get_tts()


def test_conds_profile_cache_keys_on_bucket(monkeypatch, tmp_path):
    fetched = []

    def fake_fetch(b64, r2key, bucket=None):
        fetched.append((r2key, bucket))
        p = tmp_path / f"prof{len(fetched)}.npy"
        p.write_bytes(b"x")
        return str(p)

    class StubTTS:
        def _get_or_prepare_conditionals(self, voice_profile_path=None, exaggeration=0.5):
            return ("conds", voice_profile_path)

    monkeypatch.setattr(tjobs, "_fetch_profile", fake_fetch)
    worker = RedisWorker(mode="tts", client=InMemoryStreams(), tts_factory=StubTTS)
    cache = {}
    pa = {"voice_profile_r2_key": "voices/v1.npy", "bucket": "tenant-a"}
    pb = {"voice_profile_r2_key": "voices/v1.npy", "bucket": "tenant-b"}
    ca, cb = worker._conds_for_profile(pa, cache), worker._conds_for_profile(pb, cache)
    assert len(fetched) == 2 and fetched[0] != fetched[1] and ca != cb
    assert worker._conds_for_profile(dict(pa), cache) == ca and len(fetched) == 2


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny real port pipeline on the CPU and a voice profile as base64."""
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    tts = ChatterboxTTS.from_random(seed=0, config=TINY, device="cpu")
    prof = _profile(str(tmp_path_factory.mktemp("w") / "voice.npy"), 21, 8)
    return tts, base64.b64encode(pathlib.Path(prof).read_bytes()).decode()


def _capped(tts, monkeypatch, name):
    """The job API has no token cap; the tiny T3 has 132 speech positions."""
    real = getattr(tts, name)
    monkeypatch.setattr(tts, name, lambda *a, **k: real(*a, max_new_tokens=16, **k))


def _assert_done(client, job_id, story_id, continuous=False):
    status = client.hgetall(f"runpod:job:{job_id}")
    assert status["status"] == "done", status.get("error")
    result = json.loads(status["result"])
    assert result["status"] == "success" and result["duration"] > 0
    assert result["story_id"] == story_id
    assert result["metadata"]["chunk_stats"].get("continuous", False) is continuous
    stored = pathlib.Path(result["storage_url"])
    assert stored.exists() and stored.stat().st_size > 500
    return result


def test_run_once_real_job(tiny, store, monkeypatch):
    tts, prof = tiny
    _capped(tts, monkeypatch, "generate_long_text")
    client = InMemoryStreams()
    worker = RedisWorker(mode="tts", client=client, tts_factory=lambda: tts)
    _job(client, "r1", story_id="s1", user_id="u", text="The knight rode far.",
         voice_profile_b64=prof)
    assert worker.run_once() == 1
    _assert_done(client, "r1", "s1")


def test_run_once_pools_with_max_batch(tiny, store, monkeypatch):
    """WORKER_MAX_BATCH > 1: waiting jobs run as one pooled decode; each keeps
    its own status, payload and stored audio; a job without a voice gets
    its own error and DLQ entry."""
    tts, prof = tiny
    monkeypatch.setenv("WORKER_MAX_BATCH", "4")
    _capped(tts, monkeypatch, "generate_long_text_batch")
    client = InMemoryStreams()
    worker = RedisWorker(mode="tts", client=client, tts_factory=lambda: tts)
    texts = ["The knight rode far.", "The dragon was kind.", "They became friends."]
    for i, text in enumerate(texts):
        _job(client, f"jb{i}", story_id=f"sb{i}", user_id="ub", text=text,
             voice_profile_b64=prof, exaggeration=0.4 + 0.1 * i)
    _job(client, "bad", story_id="sx", user_id="ub", text="No voice profile for me.")
    assert worker.run_once() == 4
    for i in range(3):
        result = _assert_done(client, f"jb{i}", f"sb{i}")
        assert result["metadata"]["chunk_stats"]["pooled_jobs"] == 3
        assert result["metadata"]["batched_jobs"] == 3
    bad = client.hgetall("runpod:job:bad")
    assert bad["status"] == "error" and "voice_profile" in bad["error"]
    assert [f["job_id"] for _, f in client.streams[DLQ_STREAM]] == ["bad"]
    key = (STREAM_TTS, worker.group)
    assert len(client.delivered[key]) == 4 and len(client.acked[key]) == 4


def _continuous_env(monkeypatch):
    monkeypatch.setenv("WORKER_CONTINUOUS", "1")
    monkeypatch.setenv("WORKER_SLOTS", "2")
    monkeypatch.setenv("WORKER_TEXT_BUCKET", "24")
    monkeypatch.setenv("WORKER_BLOCK", "8")
    monkeypatch.setenv("WORKER_MAX_NEW_TOKENS", "16")


def test_run_continuous(tiny, store, monkeypatch):
    """Jobs stream through one engine; a job the engine cannot admit (no
    voice profile) takes the single-job path and reports its own error and
    DLQ entry; while jobs are live the stream is polled without blocking
    (block=None; redis reads BLOCK 0 as forever); the profile cache prepares
    the one voice once."""
    tts, prof = tiny
    _continuous_env(monkeypatch)
    misses = tts.get_conditional_cache_stats()["misses"]

    class SpyClient(InMemoryStreams):
        def __init__(self):
            super().__init__()
            self.blocks = []

        def xreadgroup(self, group, consumer, streams, count=1, block=0):
            self.blocks.append(block)
            return super().xreadgroup(group, consumer, streams, count=count, block=block)

    client = SpyClient()
    worker = RedisWorker(mode="tts", client=client, tts_factory=lambda: tts)
    texts = ["The knight rode far.", "The dragon was kind.", "They became friends."]
    for i, text in enumerate(texts):
        _job(client, f"jc{i}", story_id=f"sc{i}", user_id="uc", text=text,
             voice_profile_b64=prof, exaggeration=0.4 + 0.1 * i)
    _job(client, "cbad", story_id="scx", user_id="u", text="No voice profile for me.")
    assert worker.run_continuous(stop_when_drained=True) == 4
    for i in range(3):
        result = _assert_done(client, f"jc{i}", f"sc{i}", continuous=True)
        assert result["metadata"]["engine"]["steps_run"] > 0
    bad = client.hgetall("runpod:job:cbad")
    assert bad["status"] == "error" and "voice_profile" in bad["error"]
    assert [f["job_id"] for _, f in client.streams[DLQ_STREAM]] == ["cbad"]
    assert len(client.acked[(STREAM_TTS, worker.group)]) == 4
    assert None in client.blocks and 0 not in client.blocks
    assert tts.get_conditional_cache_stats()["misses"] - misses <= 1


def test_run_continuous_pump_failure_fails_jobs(tiny, store, monkeypatch):
    """A pump that keeps failing fails its in-flight jobs visibly (status
    error, DLQ, ack) and raises: a fault on the card is never a silent
    success."""
    import time as _time
    from chatterbox_embed_tpu_torch.serving import continuous as tcont
    tts, prof = tiny
    _continuous_env(monkeypatch)

    def boom(self):
        raise RuntimeError("flash_decode kernel launch failed: cudaError 700")

    monkeypatch.setattr(tcont.ContinuousStoryServer, "pump", boom)
    monkeypatch.setattr(_time, "sleep", lambda s: None)
    client = InMemoryStreams()
    worker = RedisWorker(mode="tts", client=client, tts_factory=lambda: tts)
    _job(client, "pf0", story_id="pf0", user_id="u", text="A short line.",
         voice_profile_b64=prof)
    with pytest.raises(RuntimeError, match="cudaError 700"):
        worker.run_continuous(stop_when_drained=True)
    status = client.hgetall("runpod:job:pf0")
    assert status["status"] == "error" and "cudaError 700" in status["error"]
    assert len(client.streams[DLQ_STREAM]) == 1
    assert len(client.acked[(STREAM_TTS, worker.group)]) == 1


# -- the clone pipeline ------------------------------------------------------------

def test_clone_pipeline_matches_jax(store, monkeypatch, tmp_path):
    """create_voice_clone in both packages on the same reference audio,
    through clone_voice (the worker's entry): success, the same result keys,
    the same storage keys, a stored profile with the same fields, an MP3
    (WAV without ffmpeg) sample, the same Firestore fields. The sample's
    TTS is the VC's own `tts`, stubbed to a fixed tone in both (the tiny
    T3 has 132 speech positions, and the sample asks for 1000 tokens)."""
    import chatterbox_embed_tpu.vc as jvc
    from chatterbox_embed_tpu_torch import vc as tvc
    from chatterbox_embed_tpu_torch.weights import from_jax_params
    from test_torch_conditioning import CFG, voice
    jax_vc = jvc.ChatterboxVC.from_random(seed=0, config=CFG)
    state = from_jax_params(jax_vc.t3_params, jax_vc.s3gen_params, CFG,
                            ve_params=jax_vc.ve_params)
    port = tvc.ChatterboxVC(state["s3gen"], state["t3"], state["ve"], jax_vc.tokenizer,
                            config=CFG, device="cpu")
    tone = (0.3 * np.sin(np.linspace(0, 300, 9600))).astype(np.float32)[None]
    for vc in (jax_vc, port):
        monkeypatch.setattr(vc, "tts", lambda text, **kw: tone)
    ref = tmp_path / "ref.wav"
    taudio.write_wav(str(ref), voice(1, 2.4, 24_000), 24_000)
    audio_b64 = base64.b64encode(ref.read_bytes()).decode()
    results = []
    for m, vc, vid in ((jvc, jax_vc, "vj"), (tvc, port, "vt")):
        res = m.clone_voice(vc, voice_id=vid, voice_name="Test Voice", user_id="u1",
                            audio_b64=audio_b64)
        assert res["status"] == "success", res
        results.append(res)
    rj, rt = results
    assert set(rt) == set(rj)
    assert rt["profile_key"] == rj["profile_key"].replace("vj", "vt")
    assert rt["sample_key"] == rj["sample_key"].replace("vj", "vt")
    pj, pt = (np.load(r["profile_url"], allow_pickle=True).item() for r in (rj, rt))
    assert set(pt) == set(pj) and "embedding" in pt
    for k in ("prompt_token", "prompt_token_len"):
        np.testing.assert_array_equal(pt[k], pj[k])
    np.testing.assert_allclose(pt["embedding"], pj["embedding"], atol=1e-3)
    assert pathlib.Path(rt["sample_url"]).read_bytes() == pathlib.Path(
        rj["sample_url"]).read_bytes()
    docs = [json.loads((store / "firestore" / "voice_profiles" / f"{v}.json").read_text())
            for v in ("vj", "vt")]
    for d in docs:
        d.pop("created_at")
    assert docs[1] == {k: (v.replace("vj", "vt") if isinstance(v, str) else v)
                       for k, v in docs[0].items()}
