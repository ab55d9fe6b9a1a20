"""Serving on a mesh (chatterbox_embed_tpu_torch/parallel/): the port's
counterparts of tests/test_parallel.py's serving cases, on worlds of 2-4
processes over gloo on the CPU, and the int8 settings (ROADMAP item 22).

One world of 4 ranks is started for the module (rendezvous through a
temporary file) and every mesh below reuses it: a 2-rank mesh runs on its
first two ranks. The followers import tests/torch_dist.py, never jax. At
the module's end the world shuts down and every follower is joined.

- dp = 4: generate_batch of 4 utterances (8 CFG rows, 2 a rank) equals one
  process bit for bit, and so does a dp-only serving mesh (tp = 1).
- The JAX package's generate_batch on its 8-virtual-device dp mesh equals
  the port's one-process tokens under `JaxDraws` (in this process).
- tp = 4 and dp x tp = 2 x 2: prefill logits within 2e-4 of one process
  and of the JAX package's start_generation on its own tp = 4 and 2 x 2
  meshes (the tp sums reassociate, as in tests/test_parallel.py), each rank holds
  its Megatron shard, the decode is valid; per-utterance conditioning made
  on the leader's device works on the 2 x 2 mesh. The alignment guard's
  spy row summed over tp equals one process's; under dp the guard and the
  deferred insert (CHATTERBOX_DEFER_KV=1) equal one process.
- The engine at dp = 2 (4 slots, 2 a rank) equals the one-process engine
  token for token, with the same blocks and steps.
- `tts.enable_mesh` on the tiny pipeline: generate_batch's wavs equal the
  unmeshed pipeline's; the Redis worker under WORKER_MESH=2x1 runs a job.
- Refusals: rows or slots that do not divide dp, a streamed request on a
  mesh, a malformed WORKER_MESH; make_mesh's shapes. A T3 train step on
  the 2 x 2 mesh equals one process's (training on a mesh, and sp and pp:
  tests/test_torch_parallel_train.py).
  A rank that fails fails the call on the leader and closes the world.
- A shard tree or an engine that the leader drops is released on the
  followers with the next call; a mesh built again reuses its key.
- int8 (ROADMAP item 22, which replaced F1's refusals): from_local(int8=
  True), CHATTERBOX_INT8=1 and CHATTERBOX_INT8_S3GEN=1 load int8 trees
  equal to utils/quantize.py's; CHATTERBOX_INT8_KV=1 decodes with the int8
  cache alone, on dp = 2 (bit for bit), on tp = 2 (logits within 2e-4)
  and in the engine; CHATTERBOX_INT8_KV=2 and an unparseable value raise;
  0 or unset decodes as before.
"""
import base64
import gc
import json
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import LlamaConfig as JLlamaConfig, T3Config as JT3Config
from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu.parallel import make_dp_mesh as jax_dp_mesh
from chatterbox_embed_tpu.parallel import make_dp_tp_mesh as jax_dp_tp_mesh
from chatterbox_embed_tpu.parallel import make_tp_mesh as jax_tp_mesh
from chatterbox_embed_tpu.parallel import shard_t3_for_decode as jax_shard_t3_for_decode
from chatterbox_embed_tpu_torch import parallel
from chatterbox_embed_tpu_torch import training
from chatterbox_embed_tpu_torch.models import t3 as tt3
from chatterbox_embed_tpu_torch.models import t3_engine as teng
from chatterbox_embed_tpu_torch.parallel import mesh as tmesh
from chatterbox_embed_tpu_torch.serving import continuous as tcont
from chatterbox_embed_tpu_torch.serving.worker import STREAM_TTS, InMemoryStreams, RedisWorker
from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
from torch_dist import (TINY, fail_on, generation_info, kept_keys, shard_widths, spy_row,
                        tiny_conds, tiny_pipeline_config, tree_of)
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)
JTINY = JT3Config(
    llama=JLlamaConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                       num_heads=4, num_kv_heads=4, head_dim=16),
    text_tokens_dict_size=50, speech_tokens_dict_size=40,
    start_speech_token=36, stop_speech_token=37,
    max_text_tokens=64, max_speech_tokens=128,
    speaker_embed_size=16, speech_cond_prompt_len=6)
KW = dict(max_new_tokens=12, cfg_weight=0.4, seed=9, cfg=TINY, device="cpu")
LOGIT_TOL = 2e-4


@pytest.fixture(scope="module")
def world():
    """The module's world of 4 ranks on the CPU; joined at the end."""
    mesh = parallel.make_mesh(4, tp=1, device="cpu")
    procs = list(tmesh._WORLD.procs)
    assert len(procs) == 3 and all(p.is_alive() for p in procs)
    yield mesh
    parallel.shutdown()
    for p in procs:
        p.join(timeout=30)
    assert not any(p.is_alive() for p in procs)


@pytest.fixture(scope="module")
def models():
    jp = jt3.init(jax.random.PRNGKey(0), JTINY)
    return jp, port_params(tt3.init, TINY, jp, "T3")


@pytest.fixture
def inputs():
    rng = np.random.default_rng(0)
    spk = rng.standard_normal((1, 16)).astype(np.float32)
    prompt = rng.integers(0, 36, (1, 6)).astype(np.int32)
    texts = rng.integers(1, 50, (4, 10)).astype(np.int32)
    texts[:, 0] = 5
    texts[:, -1] = 0
    return (jt3.T3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5),
            tt3.T3Cond(t(spk), t(prompt), 0.5), texts)


def _valid(toks):
    assert toks.size >= 1 and toks.dtype == np.int32
    assert np.all((toks >= 0) & (toks < TINY.speech_tokens_dict_size))


def _logits(params, cond, texts, mesh=None):
    state, _ = tt3.start_generation(params, cond, texts, cfg_weight=0.4, max_new_tokens=12,
                                    cfg=TINY, device="cpu", mesh=mesh)
    return state.logits


def _jax_logits(jp, jcond, texts, jmesh):
    """The JAX package's prefill logits on its own mesh (8 virtual CPU
    devices, conftest), the backbone Megatron-sharded over its tp axis."""
    state, _ = jt3.start_generation(jax_shard_t3_for_decode(jmesh, jp), jcond, texts,
                                    cfg_weight=0.4, max_new_tokens=12, mesh=jmesh, cfg=JTINY)
    return np.asarray(state.logits)


# -- dp -------------------------------------------------------------------------

def test_dp_batch_matches_one_process_bit_for_bit(world, models, inputs):
    _, tp = models
    _, cond, texts = inputs
    plain = tt3.generate_batch(tp, cond, texts, **KW)
    mesh = parallel.make_dp_mesh(4, device="cpu")
    sv = parallel.shard_t3_for_serving(mesh, tp)
    out = tt3.generate_batch(sv, cond, texts, mesh=mesh, **KW)
    assert len(out) == len(plain) == 4
    for a, b in zip(plain, out):
        np.testing.assert_array_equal(b, a)
    infos = mesh.call_all(generation_info)
    assert [i["mesh"] for i in infos] == [{"dp": 4}] * 4
    assert tt3.LAST_GENERATION_INFO["mesh"] == {"dp": 4}
    # a replicated leaf on the leader is the tensor it was given
    assert sv["speech_head"]["w"] is tp["speech_head"]["w"]


def test_jax_dp_mesh_equals_the_port(models, inputs):
    """The JAX package's dp mesh (8 virtual CPU devices, conftest) and the
    port in one process, on the same weights and the same draws."""
    jp, tp = models
    jcond, cond, texts = inputs
    jout = jt3.generate_batch(jp, jcond, texts, mesh=jax_dp_mesh(4), max_new_tokens=12,
                              cfg_weight=0.4, seed=9, cfg=JTINY)
    assert jt3.LAST_GENERATION_INFO["mesh"] == {"dp": 4}
    out = tt3.generate_batch(tp, cond, texts, make_draws=JaxDraws, **KW)
    for a, b in zip(jout, out, strict=True):
        np.testing.assert_array_equal(b, np.asarray(a))


# -- tp and dp x tp --------------------------------------------------------------

def test_tp_prefill_logits_and_decode(world, models, inputs):
    jp, tp = models
    jcond, cond, texts = inputs
    mesh = parallel.make_tp_mesh(4, device="cpu")
    assert mesh.shape == {"tp": 4}
    sv = parallel.shard_t3_for_decode(mesh, tp)
    assert mesh.call_all(shard_widths, sv, mesh) == [
        (r, 0, r, 16, 16, 16, 32, 32, (64, 40)) for r in range(4)]
    ref = _logits(tp, cond, texts[:1])
    got = _logits(sv, cond, texts[:1], mesh).numpy()
    np.testing.assert_allclose(got, ref.numpy(), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(got, _jax_logits(jp, jcond, texts[:1], jax_tp_mesh(4)),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    toks = tt3.generate(sv, cond, texts[:1], mesh=mesh, **KW)
    _valid(toks)
    assert tt3.LAST_GENERATION_INFO["mesh"] == {"tp": 4}


def test_dp_tp_mesh(world, models, inputs):
    """2 x 2: logits within the tolerance and a valid decode; per-utterance
    conditioning made on the leader's device; a dp-only serving mesh
    replicates and equals one process."""
    jp, tp = models
    jcond, cond, texts = inputs
    mesh = parallel.make_dp_tp_mesh(4, tp=2, device="cpu")
    assert mesh.shape == {"dp": 2, "tp": 2} and mesh.axis_names == ("dp", "tp")
    sv = parallel.shard_t3_for_serving(mesh, tp)
    assert [w[:5] for w in mesh.call_all(shard_widths, sv, mesh)] == [
        (0, 0, 0, 32, 32), (1, 0, 1, 32, 32), (2, 1, 0, 32, 32), (3, 1, 1, 32, 32)]
    got = _logits(sv, cond, texts, mesh).numpy()
    np.testing.assert_allclose(got, _logits(tp, cond, texts).numpy(), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    jmesh = jax_dp_tp_mesh(4, tp=2)
    assert jmesh.shape == {"dp": 2, "tp": 2}
    np.testing.assert_allclose(got, _jax_logits(jp, jcond, texts, jmesh), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    out = tt3.generate_batch(sv, cond, texts, mesh=mesh, **KW)
    assert len(out) == 4
    for toks in out:
        _valid(toks)
    assert tt3.LAST_GENERATION_INFO["mesh"] == {"dp": 2, "tp": 2}
    rng = np.random.default_rng(3)
    per_row = tt3.T3Cond(
        torch.as_tensor(rng.standard_normal((4, 16)).astype(np.float32), device=mesh.device),
        cond.cond_prompt_speech_tokens.expand(4, -1).to(mesh.device),
        torch.tensor([0.3, 0.5, 0.7, 0.9], device=mesh.device))
    out_c = tt3.generate_batch(sv, per_row, texts, mesh=mesh, **KW)
    assert len(out_c) == 4 and all(o.size >= 1 for o in out_c)
    dp_mesh = parallel.make_dp_tp_mesh(4, tp=1, device="cpu")
    sv_dp = parallel.shard_t3_for_serving(dp_mesh, tp)
    assert [w[3] for w in dp_mesh.call_all(shard_widths, sv_dp, dp_mesh)] == [64] * 4
    plain = tt3.generate_batch(tp, cond, texts, **KW)
    same = tt3.generate_batch(sv_dp, cond, texts, mesh=dp_mesh, **KW)
    for a, b in zip(plain, same, strict=True):
        np.testing.assert_array_equal(b, a)


def test_alignment_guard_and_deferred_insert_on_a_mesh(world, models, inputs, monkeypatch):
    """The guard's spy row summed over tp (each rank's partial head mean
    weighted (H/tp)/H) equals one process's; under dp the guard's and the
    deferred insert's tokens equal one process's."""
    _, tp = models
    _, cond, texts = inputs
    mesh = parallel.make_tp_mesh(4, device="cpu")
    sv = parallel.shard_t3_for_decode(mesh, tp)
    want = spy_row(tp, cond, texts)
    for row in mesh.call_all(spy_row, sv, cond, texts, mesh):
        np.testing.assert_allclose(row.numpy(), want.numpy(), atol=1e-6, rtol=1e-5)
    dp = parallel.make_dp_mesh(4, device="cpu")
    sv = parallel.shard_t3_for_serving(dp, tp)
    for kw, env in ((dict(alignment=True), "0"), ({}, "1")):
        monkeypatch.setenv("CHATTERBOX_DEFER_KV", env)
        plain = tt3.generate_batch(tp, cond, texts, **kw, **KW)
        out = tt3.generate_batch(sv, cond, texts, mesh=dp, **kw, **KW)
        for a, b in zip(plain, out, strict=True):
            np.testing.assert_array_equal(b, a)


# -- the engine ------------------------------------------------------------------

def _engine_run(params, cond, texts, mesh=None):
    dec = teng.ContinuousDecoder(params, TINY, slots=4, text_bucket=16, max_new_tokens=24,
                                 block=8, mesh=mesh, device="cpu")
    limits = [24, 7, 18, 11, 24, 5]
    rids = [dec.submit(texts[i % 4:i % 4 + 1, :6 + i % 3], cond, temperature=0.8,
                       cfg_weight=0.5, seed=20 + i, max_new_tokens=limits[i])
            for i in range(6)]
    res = dec.drain()
    return [res[r] for r in rids], (dec.blocks_run, dec.steps_run, dec.state.g)


def test_engine_dp_slots_match_one_process(world, models, inputs):
    _, tp = models
    _, cond, texts = inputs
    mesh = parallel.make_dp_mesh(2, device="cpu")
    sv = parallel.shard_t3_for_serving(mesh, tp)
    plain, plain_run = _engine_run(tp, cond, texts)
    out, run = _engine_run(sv, cond, texts, mesh)
    assert run == plain_run
    for a, b in zip(plain, out, strict=True):
        np.testing.assert_array_equal(b, a)


# -- the pipeline and the worker ------------------------------------------------

@pytest.fixture(scope="module")
def tiny_tts():
    cfg = tiny_pipeline_config()
    tts = ChatterboxTTS.from_random(seed=0, config=cfg, device="cpu")
    tts.conds = tiny_conds(cfg)
    return tts


def test_enable_mesh_generate_batch(world, tiny_tts):
    tts = tiny_tts
    texts = ["Hello world.", "A second test utterance.", "Third one."]
    kw = dict(max_new_tokens=16, seed=3, temperature=[0.6, 0.7, 0.8])
    plain = tts.generate_batch(texts, **kw)
    mesh = tts.enable_mesh(2, tp=1, device="cpu")
    try:
        assert tts.mesh is mesh and mesh.shape == {"dp": 2, "tp": 1}
        out = tts.generate_batch(texts, **kw)
        for a, b in zip(plain, out, strict=True):
            np.testing.assert_array_equal(b, a)
        assert tt3.LAST_GENERATION_INFO["mesh"] == {"dp": 2, "tp": 1}
        # the stream keeps the unsharded T3 on the leader's device
        chunks = list(tts.stream_generate(texts[0], block_tokens=8, max_new_tokens=16))
        assert chunks and all(np.isfinite(c).all() for c in chunks)
        with pytest.raises(ValueError, match="stream=True"):
            tcont.ContinuousServer(tts, slots=2, text_bucket=32, max_new_tokens=16,
                                   block=8).submit(texts[0], stream=True)
        with pytest.raises(ValueError, match="multiple of the dp"):
            tcont.ContinuousServer(tts, slots=3, text_bucket=32, max_new_tokens=16)
    finally:
        tts.mesh, tts.t3_params = None, tts._t3_params_single


def test_worker_mesh_runs_a_job(world, tiny_tts, tmp_path, monkeypatch):
    from chatterbox_embed_tpu_torch.models import s3gen as ts3gen
    for key in ("WORKER_MAX_BATCH", "WORKER_CONTINUOUS", "WORKER_WARMUP", "R2_ACCOUNT_ID",
                "R2_ENDPOINT", "CHATTERBOX_ENABLE_DIRECT_FIRESTORE_UPDATE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("CHATTERBOX_LOCAL_STORAGE", str(tmp_path / "store"))
    monkeypatch.setenv("WORKER_MESH", "2x1")
    tts = tiny_tts
    real = tts.generate_long_text
    monkeypatch.setattr(tts, "generate_long_text",
                        lambda *a, **k: real(*a, max_new_tokens=16, **k))
    rng = np.random.default_rng(21)
    prof = str(tmp_path / "voice.npy")
    ts3gen.VoiceProfile(
        embedding=rng.standard_normal((1, 192)).astype(np.float32),
        prompt_feat=rng.standard_normal((1, 16, 8)).astype(np.float32),
        prompt_token=rng.integers(0, 6561, (1, 8)).astype(np.int64),
        prompt_token_len=np.array([8]),
        ve_embedding=rng.standard_normal((1, 256)).astype(np.float32)).save(prof)
    client = InMemoryStreams()
    worker = RedisWorker(mode="tts", client=client, tts_factory=lambda: tts, mesh_device="cpu")
    client.xadd(STREAM_TTS, {"payload": json.dumps({
        "job_id": "m1", "type": "tts", "story_id": "s1", "user_id": "u",
        "text": "The knight rode far.",
        "voice_profile_b64": base64.b64encode(pathlib.Path(prof).read_bytes()).decode()})})
    try:
        assert worker.run_once() == 1
        assert tts.mesh is not None and tts.mesh.shape == {"dp": 2, "tp": 1}
        status = client.hgetall("runpod:job:m1")
        assert status["status"] == "done", status.get("error")
        result = json.loads(status["result"])
        assert result["status"] == "success" and result["duration"] > 0
        assert pathlib.Path(result["storage_url"]).stat().st_size > 500
    finally:
        tts.mesh, tts.t3_params = None, tts._t3_params_single


# -- refusals and shapes ----------------------------------------------------------

def test_refusals(world, models, inputs):
    """Each refusal raises on the leader before anything is sent: the world
    serves the next call."""
    _, tp = models
    _, cond, texts = inputs
    mesh = parallel.make_dp_mesh(4, device="cpu")
    sv = parallel.shard_t3_for_serving(mesh, tp)
    with pytest.raises(ValueError, match="6 batch rows do not divide the dp axis"):
        tt3.generate_batch(sv, cond, texts[:3], mesh=mesh, **KW)
    with pytest.raises(ValueError, match="2 batch rows do not divide the dp axis"):
        tt3.generate(sv, cond, texts[:1], mesh=mesh, **KW)
    with pytest.raises(ValueError, match="6 engine slots do not divide the dp axis"):
        teng.ContinuousDecoder(sv, TINY, slots=6, text_bucket=16, max_new_tokens=24,
                               mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="inside a mesh call"):
        state, ginfo = tt3.start_generation(sv, cond, texts, cfg_weight=0.4,
                                            max_new_tokens=12, cfg=TINY, device="cpu",
                                            mesh=mesh)
        tt3.decode_block(sv, state, ginfo, None, None, block=4, limit=4, use_top_p=False,
                         stop_on_eos=True, cfg=TINY, dtype=torch.float32, mesh=mesh)
    out = tt3.generate_batch(sv, cond, texts, mesh=mesh, **KW)
    assert len(out) == 4


@pytest.mark.parametrize("spec", ["2", "2x", "x2", "2x2x1", "0x2", "two", "2*2"])
def test_malformed_worker_mesh_raises(spec, monkeypatch):
    monkeypatch.setenv("WORKER_MESH", spec)
    with pytest.raises(ValueError, match="WORKER_MESH"):
        RedisWorker(mode="tts", client=InMemoryStreams(), tts_factory=lambda: None)


def test_a_train_step_still_refuses_a_mesh(world, models, inputs):
    """Named for what it held before training on a mesh was ported: a T3
    train step on the module's world (dp x tp = 2 x 2) now runs and equals
    one process's step (loss and every leaf within 1e-5, the perceiver's
    key bias, a rounding-noise gradient, within lr), as
    tests/test_torch_parallel_train.py holds it against the JAX package."""
    _, tp = models
    rng = np.random.default_rng(3)
    batch = {"speaker_emb": rng.standard_normal((4, 16)).astype(np.float32),
             "cond_prompt_tokens": rng.integers(0, 36, (4, 6)).astype(np.int32),
             "emotion_adv": np.full((4, 1, 1), 0.5, np.float32),
             "text_tokens": rng.integers(1, 50, (4, 8)).astype(np.int32),
             "text_lens": np.asarray([8, 3, 6, 5], np.int32),
             "speech_tokens": rng.integers(0, 36, (4, 10)).astype(np.int32),
             "speech_lens": np.asarray([10, 7, 2, 9], np.int32)}
    one = training.init_t3_train_state(tp, device="cpu")
    one, want = training.make_t3_train_step(None, TINY)(one, batch)
    mesh = parallel.make_mesh(4, tp=2, device="cpu")
    state = training.shard_t3_state(training.init_t3_train_state(tp, device="cpu"), mesh)
    state, got = training.make_t3_train_step(mesh, TINY)(state, batch)
    assert state.step == one.step == 1
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=1e-5, rtol=1e-5)
    shards = mesh.call_all(tree_of, state.params)
    for li, layer in enumerate(one.params["llama"]["layers"]):
        q = torch.cat([shards[r]["llama"]["layers"][li]["q"]["w"] for r in (0, 1)], dim=1)
        o = torch.cat([shards[r]["llama"]["layers"][li]["o"]["w"] for r in (0, 1)], dim=0)
        torch.testing.assert_close(q, layer["q"]["w"].detach(), atol=1e-5, rtol=0)
        torch.testing.assert_close(o, layer["o"]["w"].detach(), atol=1e-5, rtol=0)
    for name in ("speech_head", "text_emb"):
        torch.testing.assert_close(shards[3][name]["w"], one.params[name]["w"].detach(),
                                   atol=1e-5, rtol=0)


def test_make_mesh_shapes(world):
    """tests/test_parallel.py's test_training_mesh_shapes: tp defaults to
    the largest of 4 and 2 that divides n."""
    for n, tp, shape in ((4, None, (1, 4)), (2, None, (1, 2)), (3, None, (3, 1)),
                         (4, 2, (2, 2)), (4, 1, (4, 1))):
        mesh = parallel.make_mesh(n, tp=tp, device="cpu")
        assert mesh.devices.shape == shape and mesh.axis_names == ("dp", "tp")
        assert mesh.shape == {"dp": shape[0], "tp": shape[1]}
    with pytest.raises(ValueError, match="does not divide"):
        parallel.make_mesh(4, tp=3, device="cpu")
    assert parallel.MeshAxes() == ("dp", "tp")
    spec = parallel.t3_param_spec(tt3.init(tt3.L.Init(device="meta"), TINY))
    assert spec["llama"]["layers"][1]["o"]["w"] == parallel.P("tp", None)
    assert spec["speech_head"]["w"] == parallel.P()


def test_dropped_objects_are_released_on_the_followers(world, models, inputs):
    """A shard tree and an engine that the leader drops leave the
    followers' keeps with the next call; a mesh built again over the same
    shape reuses its key, so rebuilding meshes and trees in a loop leaves
    nothing behind on any rank."""
    _, tp = models
    _, cond, texts = inputs
    mesh = parallel.make_dp_mesh(4, device="cpu")
    assert parallel.make_dp_mesh(4, device="cpu").key == mesh.key
    before = mesh.call_all(kept_keys)
    assert before[0] == [] and all(mesh.key in k for k in before[1:])
    sv = parallel.replicate(mesh, tp)
    dec = teng.ContinuousDecoder(sv, TINY, slots=4, text_bucket=16, max_new_tokens=8,
                                 mesh=mesh, device="cpu")
    keys = {tmesh._KEY_OF[id(sv)], tmesh._KEY_OF[id(dec)]}
    held = mesh.call_all(kept_keys)
    assert all(keys <= set(k) for k in held[1:])
    del sv, dec
    gc.collect()
    assert mesh.call_all(kept_keys) == before
    for _ in range(3):
        again = parallel.make_dp_mesh(4, device="cpu")
        parallel.replicate(again, tp)
        gc.collect()
    assert mesh.call_all(kept_keys) == before
    with pytest.raises(TypeError, match="plain dict"):
        mesh.make(dict)
    assert mesh.call_all(kept_keys) == before


def test_a_failed_rank_fails_the_call_and_closes_the_world(world):
    """A follower that raises sends its traceback and exits; the ranks
    waiting on it fail out of their collective; the call raises on the
    leader, every old process is joined, the closed world refuses calls,
    and the next mesh starts a new world. Runs last of the mesh tests: it
    ends the module's world."""
    mesh = parallel.make_mesh(4, tp=1, device="cpu")
    procs = list(tmesh._WORLD.procs)
    with pytest.raises(RuntimeError, match="(?s)mesh call failed.*planted failure on rank 2"):
        mesh.call(fail_on, 2, mesh)
    assert not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="world is closed"):
        mesh.call(fail_on, 9, mesh)
    fresh = parallel.make_dp_mesh(2, device="cpu")
    assert [float(x) for x in fresh.call_all(fail_on, 9, fresh)] == [2.0, 2.0]


# -- F1 and item 22: the int8 settings load -------------------------------------

@pytest.fixture
def converted(monkeypatch):
    """from_local's reads answered with the tiny pipeline's trees as the
    port's converters (utils/weights.py) return them from a reference
    checkpoint: numpy arrays in the port's layout (no reference checkpoint
    can be written here). Returns the config and the trees."""
    from chatterbox_embed_tpu_torch import tts as ttts
    from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer
    cfg = tiny_pipeline_config()
    src = ChatterboxTTS.from_random(seed=3, config=cfg, device="cpu")
    trees = {"ve": src.ve_params, "t3": src.t3_params, "s3gen": src.s3gen_params}

    def arrays(tree):
        if isinstance(tree, dict):
            return {k: arrays(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [arrays(v) for v in tree]
        return tree.numpy().copy()
    monkeypatch.setattr(ttts.weights_mod, "load_safetensors", lambda path: path)
    monkeypatch.setattr(ttts.weights_mod, "convert_voice_encoder",
                        lambda sd, **_: arrays(trees["ve"]))
    monkeypatch.setattr(ttts.weights_mod, "convert_t3", lambda sd, **_: arrays(trees["t3"]))
    monkeypatch.setattr(ttts.weights_mod, "convert_s3gen", lambda sd, **_: arrays(trees["s3gen"]))
    monkeypatch.setattr(ttts, "EnTokenizer", lambda path: FallbackTokenizer(cfg.t3))
    for key in ("CHATTERBOX_INT8", "CHATTERBOX_INT8_S3GEN", "CHATTERBOX_INT8_KV"):
        monkeypatch.delenv(key, raising=False)
    return cfg, trees


def _int8_parts(tts) -> tuple:
    """(T3's backbone is int8, the flow stack is int8)."""
    return ("w_q" in tts.t3_params["llama"]["layers"][0]["q"],
            "w_q" in tts.s3gen_params["flow"]["decoder"]["down"]["tblocks"][0]["q"])


@pytest.mark.parametrize("key", ["CHATTERBOX_INT8", "CHATTERBOX_INT8_S3GEN"])
def test_int8_weight_settings_raise(key, converted, monkeypatch, tmp_path):
    """Item 22 replaced F1's refusal: CHATTERBOX_INT8=1 loads T3's backbone
    in int8 (equal to quantize_t3 of the full-precision load, bit for bit),
    CHATTERBOX_INT8_S3GEN=1 the flow stack (its `pos` projections fp); 0
    loads full precision; the int8 pipeline speaks."""
    from chatterbox_embed_tpu_torch.utils.quantize import quantize_s3gen, quantize_t3
    from chatterbox_embed_tpu_torch.weights import _leaves
    cfg, trees = converted
    monkeypatch.setenv(key, "0")
    assert _int8_parts(ChatterboxTTS.from_local(tmp_path, config=cfg, device="cpu")) == (
        False, False)
    monkeypatch.setenv(key, "1")
    q8 = ChatterboxTTS.from_local(tmp_path, config=cfg, device="cpu")
    want = (key == "CHATTERBOX_INT8", key == "CHATTERBOX_INT8_S3GEN")
    assert _int8_parts(q8) == want
    if want[0]:
        ref, got = quantize_t3(trees["t3"]), q8.t3_params
    else:
        ref, got = quantize_s3gen(trees["s3gen"]), q8.s3gen_params
        assert "w" in got["flow"]["encoder"]["blocks"][0]["pos"]
    for (path, a), (path_b, b) in zip(_leaves(got), _leaves(ref), strict=True):
        assert path == path_b and a.dtype == b.dtype and torch.equal(a, b), path
    q8.conds = tiny_conds(cfg)
    wav = q8.generate("hello there", max_new_tokens=8, cfg_weight=0.5, seed=0)
    assert wav.shape[0] == 1 and wav.shape[1] > 0 and np.isfinite(wav).all()


def test_from_local_int8_argument(converted, monkeypatch, tmp_path):
    """int8=True quantises T3 whatever CHATTERBOX_INT8 says, False keeps it
    full precision, None follows the setting (off when unset, the GPU
    default)."""
    cfg, _ = converted

    def load(**kw):
        return _int8_parts(ChatterboxTTS.from_local(tmp_path, config=cfg, device="cpu", **kw))
    assert load(int8=True) == (True, False)
    assert load(int8=None) == (False, False)
    assert load(int8=False) == (False, False)
    monkeypatch.setenv("CHATTERBOX_INT8", "1")
    assert load(int8=None) == (True, False)
    assert load(int8=False) == (False, False)


@pytest.mark.parametrize("value", ["1", "2"])
def test_int8_kv_setting_raises(value, world, models, inputs, monkeypatch):
    """CHATTERBOX_INT8_KV=1 (item 22) decodes with the int8 cache: alone,
    on a dp = 2 mesh (each rank's cache int8, the followers taking the
    leader's setting; tokens equal to one process bit for bit) and in the
    engine; 2, the JAX package's int8 x int8 dots, still raises: it is not
    ported yet (ROADMAP queue 1)."""
    _, tp = models
    _, cond, texts = inputs
    monkeypatch.setenv("CHATTERBOX_INT8_KV", value)
    if value == "2":
        with pytest.raises(NotImplementedError, match="CHATTERBOX_INT8_KV=2.*not ported yet"):
            tt3.generate(tp, cond, texts[:1], **KW)
        with pytest.raises(NotImplementedError, match="not ported yet"):
            teng.ContinuousDecoder(tp, TINY, slots=2, text_bucket=16, max_new_tokens=24,
                                   device="cpu")
        return
    _valid(tt3.generate(tp, cond, texts[:1], **KW))
    assert tt3.LAST_GENERATION_INFO["kv_int8"] is True
    plain = tt3.generate_batch(tp, cond, texts, **KW)
    mesh = parallel.make_dp_mesh(2, device="cpu")
    sv = parallel.shard_t3_for_serving(mesh, tp)
    out = tt3.generate_batch(sv, cond, texts, mesh=mesh, **KW)
    for a, b in zip(plain, out, strict=True):
        np.testing.assert_array_equal(b, a)
    assert [i["kv_int8"] for i in mesh.call_all(generation_info)] == [True, True]
    dec = teng.ContinuousDecoder(tp, TINY, slots=2, text_bucket=16, max_new_tokens=24,
                                 device="cpu")
    assert dec.kv_int8 and dec.state.cache.k.dtype == torch.int8
    dec.submit(texts[:1, :6], cond, seed=1)
    _valid(dec.drain()[0])


def test_int8_kv_off_decodes_as_before(models, inputs, monkeypatch):
    _, tp = models
    _, cond, texts = inputs
    monkeypatch.delenv("CHATTERBOX_INT8_KV", raising=False)
    ref = tt3.generate(tp, cond, texts[:1], **KW)
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "0")
    np.testing.assert_array_equal(tt3.generate(tp, cond, texts[:1], **KW), ref)
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "yes")
    with pytest.raises(ValueError, match="want 0, 1 or 2"):
        tt3.generate(tp, cond, texts[:1], **KW)


def test_int8_kv_on_a_tp_mesh(world, models, inputs, monkeypatch):
    """The int8 cache under tp = 2: each rank quantises and walks its H/tp
    heads (the per-(slot, row, head) scales split with the heads); prefill
    logits within LOGIT_TOL of one process's int8 prefill; the decode is
    valid. The engine's int8 cache over dp = 2 (each rank holds its slots'
    slabs and scales) equals the one-process engine token for token."""
    _, tp = models
    _, cond, texts = inputs
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    want = _logits(tp, cond, texts)
    mesh = parallel.make_tp_mesh(2, device="cpu")
    sv = parallel.shard_t3_for_decode(mesh, tp)
    np.testing.assert_allclose(_logits(sv, cond, texts, mesh).numpy(), want.numpy(),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    assert [i["kv_int8"] for i in mesh.call_all(generation_info)] == [True, True]
    for toks in tt3.generate_batch(sv, cond, texts, mesh=mesh, **KW):
        _valid(toks)
    dp = parallel.make_dp_mesh(2, device="cpu")
    plain, plain_run = _engine_run(tp, cond, texts)
    out, run = _engine_run(parallel.shard_t3_for_serving(dp, tp), cond, texts, dp)
    assert run == plain_run
    for a, b in zip(plain, out, strict=True):
        np.testing.assert_array_equal(b, a)
