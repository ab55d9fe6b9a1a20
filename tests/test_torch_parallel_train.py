"""Training on a mesh and the last two parallel axes
(chatterbox_embed_tpu_torch/parallel/, training/) against the JAX package
on the CPU, on one world of 4 processes over gloo for the module, as
tests/test_torch_parallel.py runs its world. The followers import
tests/torch_dist.py, never jax: the flow step's draws reach them as fixed
arrays made here from the JAX package's key.

- sp over 4 ranks, with tests/test_parallel.py's configs (T = 24 with a
  ragged mask; T = 21, no mask, 21 % 4 != 0): `sp_generate_mel` equals the
  port's one-process `cfm.generate_mel` within atol = rtol = 1e-5, the
  bound tests/test_parallel.py holds the JAX package's sp to (the halo and
  the gathers move values exactly; 1.4e-6 measured), and the JAX package's
  one-device solver within 1e-4, the bound of the two packages' solvers
  (tests/test_torch_cfm_batch.py): the port's one-process solver is
  2.9e-5 from JAX's on the T = 24 case after 4 Euler steps.
- pp over 4 stages x 2 microbatches: the loss equals JAX's one-device
  `t3.loss` (rtol 1e-5), `speech_head`'s and every stage's q gradient its
  `jax.value_and_grad` (rtol 2e-4, atol 1e-6), as tests/test_parallel.py
  holds its pipeline; unstack(stack(p)) == p.
- The pp train step runs (finite loss, step 1, params moved), and two pp
  steps equal two JAX one-device `make_t3_train_step` steps.
- T3 train steps at dp 2, tp 2 and dp x tp 2 x 2 equal JAX one-device
  steps over 3 steps: the loss, every leaf gathered from the shards, and
  each replicated leaf bit-equal on every rank (a tp-sharded leaf on every
  rank of its tp index).
- The flow step at dp 2 over 8 rows equals JAX `make_flow_train_step` with
  the same draws; each rank hands K3's wrapper (its plain version here) 4
  rows.
- Refusals before anything is sent: layers % stages, batch % microbatches,
  rows % dp, an sp mesh given to a train step.

Tolerances are tests/test_torch_training.py's: losses 1e-5, parameters
1e-5 after each AdamW step (a tenth of one step at lr 1e-4), the
perceiver's key bias (its gradient is rounding noise that Adam scales up)
within lr a step.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import CFMConfig as JCFMConfig
from chatterbox_embed_tpu.config import FlowDecoderConfig as JFlowDecoderConfig
from chatterbox_embed_tpu.config import LlamaConfig as JLlamaConfig
from chatterbox_embed_tpu.config import T3Config as JT3Config
from chatterbox_embed_tpu.models import cfm as jcfm
from chatterbox_embed_tpu.models import flow_decoder as jfd
from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu.parallel import make_mesh as jax_make_mesh
from chatterbox_embed_tpu.training import train_step as jts
from chatterbox_embed_tpu_torch import parallel, training
from chatterbox_embed_tpu_torch.config import CFMConfig, replace
from chatterbox_embed_tpu_torch.models import cfm as tcfm
from chatterbox_embed_tpu_torch.models import flow_decoder as tfd
from chatterbox_embed_tpu_torch.models import t3 as tt3
from chatterbox_embed_tpu_torch.parallel import mesh as tmesh
from chatterbox_embed_tpu_torch.parallel import pipeline
from chatterbox_embed_tpu_torch.weights import _leaves
from test_training import TINY as JTRAIN_TINY
from torch_dist import (FLOW_CFM, FLOW_DEC, PP_TINY, TRAIN_TINY, FixedDraws, axes, flash_rows,
                        kept_keys, pp_loss_and_grads, tf32_switches, tree_of)
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)
LR = 1e-4
ZERO_GRAD_LEAVES = ("cond_enc/perceiver/k/b",)
JPP_TINY = JT3Config(
    llama=JLlamaConfig(hidden_size=64, intermediate_size=128, num_layers=4,
                       num_heads=4, num_kv_heads=4, head_dim=16),
    text_tokens_dict_size=50, speech_tokens_dict_size=40,
    start_speech_token=36, stop_speech_token=37,
    max_text_tokens=64, max_speech_tokens=128,
    speaker_embed_size=16, speech_cond_prompt_len=6)
JDEC = JFlowDecoderConfig(in_channels=32, out_channels=8, channels=16, attention_head_dim=8,
                          num_heads=2, n_blocks=1, num_mid_blocks=1, time_embed_dim=64)


@pytest.fixture(scope="module")
def world():
    """The module's world of 4 ranks on the CPU; joined at the end."""
    mesh = parallel.make_mesh(4, tp=1, device="cpu")
    procs = list(tmesh._WORLD.procs)
    yield mesh
    parallel.shutdown()
    for p in procs:
        p.join(timeout=30)
    assert not any(p.is_alive() for p in procs)


def _pp_batch(b=4):
    """tests/test_parallel.py's pipeline batch (rng seed 0)."""
    rng = np.random.default_rng(0)
    return {
        "speaker_emb": rng.standard_normal((b, 16)).astype(np.float32),
        "cond_prompt_tokens": rng.integers(0, 36, (b, 6)).astype(np.int32),
        "emotion_adv": np.full((b,), 0.5, np.float32),
        "text_tokens": rng.integers(1, 50, (b, 8)).astype(np.int32),
        "text_lens": np.asarray([8, 6, 7, 8], np.int32),
        "speech_tokens": rng.integers(0, 36, (b, 10)).astype(np.int32),
        "speech_lens": np.asarray([10, 9, 10, 8], np.int32),
    }


def _t3_batch(seed=8, b=4):
    """tests/test_torch_training.py's T3 batch, ragged text and speech."""
    rng = np.random.default_rng(seed)
    return {
        "speaker_emb": rng.standard_normal((b, 8)).astype(np.float32),
        "cond_prompt_tokens": rng.integers(0, 36, (b, 4)).astype(np.int32),
        "emotion_adv": np.full((b, 1, 1), 0.5, np.float32),
        "text_tokens": rng.integers(0, 50, (b, 8)).astype(np.int32),
        "text_lens": np.array([8, 5, 3, 7][:b], np.int32),
        "speech_tokens": rng.integers(0, 36, (b, 12)).astype(np.int32),
        "speech_lens": np.array([12, 9, 4, 11][:b], np.int32),
    }


def _flow_batch(seed=9, b=8, tlen=16):
    rng = np.random.default_rng(seed)
    lens = np.array([tlen, 11, 5, 14, 16, 9, 13, 7][:b])
    return {
        "mel": rng.standard_normal((b, tlen, 8)).astype(np.float32),
        "mu": rng.standard_normal((b, tlen, 8)).astype(np.float32),
        "spks": rng.standard_normal((b, 8)).astype(np.float32),
        "cond": rng.standard_normal((b, tlen, 8)).astype(np.float32),
        "mask": (np.arange(tlen)[None, :, None] < lens[:, None, None]).astype(np.float32),
    }


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _assert_params_close(got_tree, jax_tree, init_fn, cfg, name, steps):
    """Every leaf within 1e-5; a ZERO_GRAD_LEAVES leaf within lr a step."""
    want = port_params(init_fn, cfg, jax_tree, name)
    got = dict(_leaves(got_tree))
    assert set(got) == {path for path, _ in _leaves(want)}
    for path, w in _leaves(want):
        atol = 1e-5 if path not in ZERO_GRAD_LEAVES else 2 * LR * steps
        np.testing.assert_allclose(got[path].numpy(), w.numpy(), atol=atol, rtol=0,
                                   err_msg=path)


def _gather_t3(trees, spec, mesh):
    """The whole T3 tree from each rank's shard tree (rank order): a leaf
    split over tp is concatenated along its split dimension from the ranks
    of dp index 0."""
    def join(path, s):
        parts = [dict(_leaves(tr))[path] for tr in trees[:mesh.tp]]
        for dim, axis in enumerate(s):
            if axis == "tp":
                return torch.cat(parts, dim=dim)
        return parts[0]
    spec_leaves = dict(_spec_leaves(spec))
    return _unflatten({path: join(path, spec_leaves[path]) for path, _ in _leaves(trees[0])},
                      trees[0])


def _spec_leaves(spec, prefix=""):
    """(path, PartitionSpec) of every leaf of a spec tree (a spec is a
    tuple, so weights._leaves would walk into it)."""
    if isinstance(spec, dict):
        return [x for k, v in spec.items() for x in _spec_leaves(v, f"{prefix}{k}/")]
    if isinstance(spec, list):
        return [x for i, v in enumerate(spec) for x in _spec_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], spec)]


def _unflatten(flat, like, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten(flat, v, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten(flat, v, f"{prefix}{i}/") for i, v in enumerate(like)]
    return flat[prefix[:-1]]


def _assert_replicas_equal(trees, spec, mesh):
    """Each leaf bit-equal on every rank that holds the same part of it."""
    spec_leaves = dict(_spec_leaves(spec))
    flat = [dict(_leaves(tr)) for tr in trees]
    for path, s in spec_leaves.items():
        split = "tp" in tuple(s)
        for r in range(1, mesh.size):
            ref = flat[r % mesh.tp] if split else flat[0]
            assert torch.equal(flat[r][path], ref[path]), f"{path} differs on rank {r}"


# -- the mesh's axes ---------------------------------------------------------------

def test_line_meshes_have_their_axis(world):
    """A 1-D sp or pp mesh: each rank its index and the whole mesh as the
    axis's group; MeshAxes stays (dp, tp) and make_mesh as before; a grid
    over sp and pp, or an unknown axis, is refused."""
    for name, make in (("sp", parallel.make_sp_mesh), ("pp", pipeline.make_pp_mesh)):
        mesh = make(4, device="cpu")
        assert mesh.axis_names == (name,) and mesh.shape == {name: 4}
        assert mesh.dp == mesh.tp == 1 and getattr(mesh, name) == 4
        got = mesh.call_all(axes, mesh)
        line = (name == "sp", name == "pp")
        assert got == [(r, 0, 0, r * line[0], r * line[1], (False, False) + line)
                       for r in range(4)]
        assert mesh.rows(6) == (0, 6)
    assert parallel.MeshAxes() == ("dp", "tp")
    assert parallel.make_mesh(4, tp=2, device="cpu").axis_names == ("dp", "tp")
    for grid, names in (([["cpu", "cpu"], ["cpu", "cpu"]], ("sp", "pp")),
                        (["cpu", "cpu"], ("cp",)), ([["cpu", "cpu"]], ("dp", "dp"))):
        with pytest.raises(ValueError, match="one line axis"):
            parallel.Mesh(np.asarray(grid, dtype=object), names)


def test_followers_take_the_leaders_tf32_switches(world):
    """Each call carries the leader's TF32 switches: a spawned follower
    would otherwise convolve in TF32 on a card (cuDNN's default), which put
    an sp = 2 mel 3e-3 from one process on the H100."""
    before = tf32_switches()
    try:
        for switches in ((False, False), (True, False), (False, True)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = switches
            assert world.call_all(tf32_switches) == [switches] * 4
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


# -- sp ----------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ragged_mask_t24", "no_mask_t21"])
def test_sp_generate_mel_matches_jax(world, case):
    """tests/test_parallel.py's two sp cases, against the JAX package's
    one-device solver."""
    rng = np.random.default_rng(0)
    if case == "ragged_mask_t24":
        mid, steps, b, tlen, seed = 2, 4, 2, 24, 7
    else:
        mid, steps, b, tlen, seed = 1, 2, 1, 21, 8
    jdec = JFlowDecoderConfig(in_channels=32, out_channels=8, channels=16,
                              attention_head_dim=8, num_heads=2, n_blocks=1,
                              num_mid_blocks=mid, time_embed_dim=64)
    dec = replace(FLOW_DEC, num_mid_blocks=mid)
    jp = jfd.init(jax.random.PRNGKey(seed), jdec)
    mu = rng.standard_normal((b, tlen, 8)).astype(np.float32)
    spks = rng.standard_normal((b, 8)).astype(np.float32)
    if case == "ragged_mask_t24":
        cond = rng.standard_normal((b, tlen, 8)).astype(np.float32)
        lens = np.array([tlen, tlen - 5])
        mask = (np.arange(tlen)[None, :] < lens[:, None]).astype(np.float32)[..., None]
    else:
        cond, mask = np.zeros((b, tlen, 8), np.float32), None
    ref = jcfm.generate_mel(jp, jnp.asarray(mu), jnp.asarray(spks), jnp.asarray(cond),
                            None if mask is None else jnp.asarray(mask),
                            cfm=JCFMConfig(n_timesteps=steps), dec_cfg=jdec)
    tree = port_params(tfd.init, dec, jp, "flow_decoder")
    args = (t(mu), t(spks), t(cond), None if mask is None else t(mask))
    one = tcfm.generate_mel(tree, *args, CFMConfig(n_timesteps=steps), dec)
    mesh = parallel.make_sp_mesh(4, device="cpu")
    out = parallel.sp_generate_mel(mesh, tree, *args, cfm_cfg=CFMConfig(n_timesteps=steps),
                                   dec_cfg=dec)
    assert out.shape == (b, tlen, 8) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


# -- pp ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pp_models():
    jp = jt3.init(jax.random.PRNGKey(1), JPP_TINY)
    return jp, port_params(tt3.init, PP_TINY, jp, "T3")


def test_pp_loss_and_gradients_match_jax(world, pp_models):
    jp, tp = pp_models
    batch = _pp_batch()

    def ref_loss(params, b):
        cond = jt3.T3Cond(b["speaker_emb"], b["cond_prompt_tokens"], b["emotion_adv"])
        lt, ls = jt3.loss(params, cond, b["text_tokens"], b["text_lens"], b["speech_tokens"],
                          b["speech_lens"], JPP_TINY)
        return lt + ls

    ref, ref_grads = jax.value_and_grad(ref_loss)(jp, _jb(batch))
    want = port_params(tt3.init, PP_TINY, ref_grads, "T3")
    mesh = pipeline.make_pp_mesh(4, device="cpu")
    sharded = pipeline.shard_pp_params(pipeline.stack_t3_for_pipeline(tp, 4), mesh)
    out = mesh.call_all(pp_loss_and_grads, sharded, batch, 2, PP_TINY, mesh)
    for loss, _ in out:
        np.testing.assert_allclose(loss, float(ref), rtol=1e-5, atol=1e-6)
    for rank, (_, grads) in enumerate(out):
        np.testing.assert_allclose(grads["aux"]["speech_head"]["w"].numpy(),
                                   want["speech_head"]["w"].numpy(), rtol=2e-4, atol=1e-6)
        assert grads["stages"]["q"]["w"].shape == (1, 1, 64, 64)
        np.testing.assert_allclose(grads["stages"]["q"]["w"][0, 0].numpy(),
                                   want["llama"]["layers"][rank]["q"]["w"].numpy(),
                                   rtol=2e-4, atol=1e-6)
    # every aux gradient is one process's on every stage (the pp sum)
    for path, g in _leaves(out[0][1]["aux"]):
        for _, grads in out[1:]:
            assert torch.equal(dict(_leaves(grads["aux"]))[path], g), path
    rt = pipeline.unstack_t3_from_pipeline(pipeline.stack_t3_for_pipeline(tp, 4), PP_TINY)
    got = dict(_leaves(rt))
    assert set(got) == {path for path, _ in _leaves(tp)}
    for path, x in _leaves(tp):
        assert torch.equal(got[path], x), path


@pytest.fixture
def pp_run(world, pp_models):
    """A 4-stage, 2-microbatch pp mesh, its step and a fresh state."""
    _, tp = pp_models
    mesh = pipeline.make_pp_mesh(4, device="cpu")
    sharded = pipeline.shard_pp_params(pipeline.stack_t3_for_pipeline(tp, 4), mesh)
    step, init_state = pipeline.make_pp_train_step(mesh, n_micro=2, cfg=PP_TINY, lr=LR)
    return mesh, step, init_state(sharded)


def _pp_whole(mesh, params):
    """The whole T3 tree from every stage's part (its stages, rank 0's aux)."""
    trees = mesh.call_all(tree_of, params)
    stages = parallel.mesh._tree_map(lambda *xs: torch.cat(xs), *[tr["stages"] for tr in trees])
    return pipeline.unstack_t3_from_pipeline({"stages": stages, "aux": trees[0]["aux"]}, PP_TINY)


def test_pp_train_step_runs(pp_run):
    mesh, step, state = pp_run
    before = _pp_whole(mesh, state.params)
    state2, metrics = step(state, _pp_batch())
    assert np.isfinite(float(metrics["loss"]))
    assert state2.step == 1
    after = _pp_whole(mesh, state2.params)
    for li in range(4):
        q0, q1 = before["llama"]["layers"][li]["q"]["w"], after["llama"]["layers"][li]["q"]["w"]
        assert (q1 - q0).abs().max() > 0
    assert (after["speech_head"]["w"] - before["speech_head"]["w"]).abs().max() > 0


def test_pp_train_steps_match_jax(pp_run, pp_models):
    jp, _ = pp_models
    mesh, step, state = pp_run
    batch = _pp_batch()
    jmesh = jax_make_mesh(1)
    jstate = jts.init_t3_train_state(jp, lr=LR)
    jstep, _ = jts.make_t3_train_step(jmesh, JPP_TINY, lr=LR, remat=True)
    for i in range(2):
        with jmesh:
            jstate, jm = jstep(jstate, _jb(batch))
        state, m = step(state, batch)
        assert state.step == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5, rtol=1e-5)
    _assert_params_close(_pp_whole(mesh, state.params), jstate.params, tt3.init, PP_TINY, "T3",
                         2)
    # aux, replicated over pp, is bit-equal on every stage
    auxes = [tr["aux"] for tr in mesh.call_all(tree_of, state.params)]
    for path, a in _leaves(auxes[0]):
        assert all(torch.equal(dict(_leaves(x))[path], a) for x in auxes[1:]), path


# -- dp x tp train steps -----------------------------------------------------------

@pytest.fixture(scope="module")
def t3_models():
    jp = jt3.init(jax.random.PRNGKey(0), JTRAIN_TINY)
    return jp, port_params(tt3.init, TRAIN_TINY, jp, "T3")


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_t3_train_steps_on_a_mesh_match_jax(world, t3_models, dp, tp):
    jp, tree = t3_models
    batch = _t3_batch()
    jmesh = jax_make_mesh(1)
    jstate = jts.init_t3_train_state(jp, lr=LR)
    jstep, _ = jts.make_t3_train_step(jmesh, JTRAIN_TINY, lr=LR, remat=True)
    mesh = parallel.make_mesh(dp * tp, tp=tp, device="cpu")
    state = training.shard_t3_state(training.init_t3_train_state(tree, device="cpu"), mesh,
                                    lr=LR)
    step = training.make_t3_train_step(mesh, TRAIN_TINY, lr=LR, remat=True)
    spec = parallel.t3_param_spec(tree)
    for i in range(3):
        with jmesh:
            jstate, jm = jstep(jstate, _jb(batch))
        state, m = step(state, batch)
        assert state.step == int(jstate.step) == i + 1 and int(m["step"]) == i
        for key in ("loss", "loss_text", "loss_speech"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), atol=1e-5, rtol=1e-5)
        trees = mesh.call_all(tree_of, state.params)
        _assert_params_close(_gather_t3(trees, spec, mesh), jstate.params, tt3.init,
                             TRAIN_TINY, "T3", i + 1)
        _assert_replicas_equal(trees, spec, mesh)
    q = trees[0]["llama"]["layers"][0]["q"]["w"]
    assert q.shape == (32, 32 // tp)


def test_flow_train_steps_on_dp2_match_jax(world):
    jp = jfd.init(jax.random.PRNGKey(1), JDEC)
    tree = port_params(tfd.init, FLOW_DEC, jp, "flow_decoder")
    batch = _flow_batch()
    jmesh = jax_make_mesh(1)
    jstate = jts.init_flow_train_state(jp, lr=LR)
    jstep, _ = jts.make_flow_train_step(jmesh, JCFMConfig(), JDEC, lr=LR)
    mesh = parallel.make_dp_mesh(2, device="cpu")
    state = training.shard_flow_state(training.init_flow_train_state(tree, device="cpu"), mesh,
                                      lr=LR)
    step = training.make_flow_train_step(mesh, FLOW_CFM, FLOW_DEC, lr=LR)
    shape = batch["mel"].shape
    for i in range(2):
        draws = FixedDraws(*(a.numpy() for a in JaxDraws(i).flow_train(shape[0], shape)))
        with jmesh:
            jstate, jm = jstep(jstate, jax.random.PRNGKey(i), _jb(batch))
        if i == 0:
            assert mesh.call_all(flash_rows, state.params, draws, batch, mesh) == [[4] * 3] * 2
        state, m = step(state, draws, batch)
        assert state.step == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5, rtol=1e-5)
        trees = mesh.call_all(tree_of, state.params)
        _assert_params_close(trees[0], jstate.params, tfd.init, FLOW_DEC, "flow_decoder", i + 1)
        for (path, a), (_, b) in zip(_leaves(trees[0]), _leaves(trees[1])):
            assert torch.equal(a, b), path


# -- refusals ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["layers_over_stages", "batch_over_micro", "rows_over_dp",
                                  "sp_mesh_to_a_train_step"])
def test_refusals_raise_before_anything_is_sent(world, pp_models, t3_models, case):
    before = world.call_all(kept_keys)
    if case == "layers_over_stages":
        with pytest.raises(ValueError, match="4 layers do not split into 3 stages"):
            pipeline.stack_t3_for_pipeline(pp_models[1], 3)
    elif case == "batch_over_micro":
        mesh = pipeline.make_pp_mesh(2, device="cpu")
        step, init_state = pipeline.make_pp_train_step(mesh, n_micro=3, cfg=PP_TINY)
        state = init_state(pipeline.shard_pp_params(
            pipeline.stack_t3_for_pipeline(pp_models[1], 2), mesh))
        before = world.call_all(kept_keys)
        with pytest.raises(ValueError, match="batch 4 does not split into 3 microbatches"):
            step(state, _pp_batch())
    elif case == "rows_over_dp":
        mesh = parallel.make_dp_mesh(2, device="cpu")
        state = training.shard_t3_state(training.init_t3_train_state(t3_models[1], device="cpu"),
                                        mesh)
        step = training.make_t3_train_step(mesh, TRAIN_TINY)
        before = world.call_all(kept_keys)
        with pytest.raises(ValueError, match="3 batch rows do not divide the dp axis"):
            step(state, _t3_batch(b=3))
        with pytest.raises(ValueError, match="not on the mesh"):
            step(training.init_t3_train_state(t3_models[1], device="cpu"), _t3_batch())
    else:
        sp = parallel.make_sp_mesh(2, device="cpu")
        before = world.call_all(kept_keys)
        for make in (lambda: training.make_t3_train_step(sp, TRAIN_TINY),
                     lambda: training.make_flow_train_step(sp, FLOW_CFM, FLOW_DEC),
                     lambda: training.shard_t3_state(None, sp)):
            with pytest.raises(ValueError, match="dp x tp mesh"):
                make()
        with pytest.raises(ValueError, match="pp mesh"):
            pipeline.make_pp_train_step(sp, 2, PP_TINY)
    assert tmesh._WORLD.closed is None and all(p.is_alive() for p in tmesh._WORLD.procs)
    assert world.call_all(kept_keys) == before
