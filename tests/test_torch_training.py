"""The port's training path against the JAX package on the CPU: T3's
teacher-forced forward and loss, the flow-matching loss, the gradients of
both (JAX's `jax.grad` converted with `weights.from_jax_params`' layout
changes), one and two AdamW steps of each family against the JAX steps on
a one-device mesh, K3's backward (its plain version, what K3b computes)
against autograd of `layers.mha` in both packages, the safetensors
checkpoints and the profiling layer.

Tolerances (fp32, summation order only): logits 1e-4, losses 1e-5 (a
fault of the semantics is O(0.1)); every gradient leaf within 1e-4 of its
JAX counterpart's norm (max |difference| <= 1e-4 * ||g|| + 1e-7); parameters within 1e-5 after
each AdamW step (an update is at most lr = 1e-4 an element, so 1e-5 is a
tenth of one step). One leaf is held otherwise: the perceiver's key bias
adds q.b to every logit of a query row, which the softmax cancels, so its
gradient is 0 in exact arithmetic and rounding noise (~1e-8) in both
packages; Adam scales noise of the size of its eps to a step of up to lr,
so that leaf may differ by up to lr a step (its gradient is checked to be
noise in test_t3_gradients_match_jax). K3's backward: fp32 within 1e-5 of max(1, the largest
gradient) (the same sums in another order; the terms of a sum are O(1), so
a gradient that is 0, as dq at one key, carries O(1e-7) of rounding);
bf16 within 3e-2 of it
(the plain bf16 paths round the weights and the products to bf16, K3b's
algorithm rounds only P and dS, as the TPU op's operands, and sums in fp32:
a few bf16 steps of 2^-8).
"""
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from chatterbox_embed_tpu.config import CFMConfig, FlowDecoderConfig
from chatterbox_embed_tpu.models import cfm as jcfm
from chatterbox_embed_tpu.models import flow_decoder as jfd
from chatterbox_embed_tpu.models import layers as jlayers
from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu.parallel import make_mesh
from chatterbox_embed_tpu.training import train_step as jts
from chatterbox_embed_tpu_torch.kernels import flash_attention as tflash
from chatterbox_embed_tpu_torch.kernels import flash_attention_bwd as tbwd
from chatterbox_embed_tpu_torch.models import cfm as tcfm
from chatterbox_embed_tpu_torch.models import flow_decoder as tfd
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.models import t3 as tt3
from chatterbox_embed_tpu_torch.ops.sampling import Draws
from chatterbox_embed_tpu_torch.training import train_step as tts_
from chatterbox_embed_tpu_torch.utils import checkpoint as tckpt
from chatterbox_embed_tpu_torch.utils import profiling as tprof
from chatterbox_embed_tpu_torch.utils import weights as tw
from chatterbox_embed_tpu_torch.weights import _leaves
from test_training import TINY
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)
DEC = FlowDecoderConfig(in_channels=32, out_channels=8, channels=16, attention_head_dim=8,
                        num_heads=2, n_blocks=1, num_mid_blocks=1, time_embed_dim=64)
CFM = CFMConfig()
LR = 1e-4
# leaves whose gradient is 0 in exact arithmetic (softmax's shift invariance)
ZERO_GRAD_LEAVES = ("cond_enc/perceiver/k/b",)


def _t3_batch(seed=0, b=4):
    """test_training's batch shape, with ragged text and speech lengths."""
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


def _flow_batch(seed=0, b=4, tlen=16):
    rng = np.random.default_rng(seed)
    lens = np.array([tlen, 11, 5, 14][:b])
    return {
        "mel": rng.standard_normal((b, tlen, 8)).astype(np.float32),
        "mu": rng.standard_normal((b, tlen, 8)).astype(np.float32),
        "spks": rng.standard_normal((b, 8)).astype(np.float32),
        "cond": rng.standard_normal((b, tlen, 8)).astype(np.float32),
        "mask": (np.arange(tlen)[None, :, None] < lens[:, None, None]).astype(np.float32),
    }


def _tb(batch):
    return {k: t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def t3_models():
    jp = jt3.init(jax.random.PRNGKey(0), TINY)
    return jp, port_params(tt3.init, TINY, jp, "T3")


@pytest.fixture(scope="module")
def flow_models():
    jp = jfd.init(jax.random.PRNGKey(1), DEC)
    return jp, port_params(tfd.init, DEC, jp, "flow_decoder")


def _conds(batch):
    jc = jt3.T3Cond(jnp.asarray(batch["speaker_emb"]), jnp.asarray(batch["cond_prompt_tokens"]),
                    jnp.asarray(batch["emotion_adv"]))
    tc = tt3.T3Cond(t(batch["speaker_emb"]), t(batch["cond_prompt_tokens"]),
                    t(batch["emotion_adv"]))
    return jc, tc


def _args(batch, wrap):
    return tuple(wrap(batch[k]) for k in ("text_tokens", "text_lens", "speech_tokens",
                                          "speech_lens"))


def _assert_grads_close(port_tree, jax_tree, init_fn, cfg, name, rel=1e-4):
    """Every leaf of the port's gradient tree within rel * ||g_jax|| + 1e-7
    of the JAX gradient, converted to the port's layout."""
    want = port_params(init_fn, cfg, jax_tree, name)
    got = dict(_leaves(port_tree))
    n = 0
    for path, g in _leaves(want):
        diff = (got[path] - g).abs().max().item()
        limit = rel * g.norm().item() + 1e-7
        assert diff <= limit, f"{path}: max|diff| {diff:.3e} > {limit:.3e}"
        n += 1
    assert n == len(got)


def _grads(params):
    return {k: _grads(v) for k, v in params.items()} if isinstance(params, dict) else (
        [_grads(v) for v in params] if isinstance(params, list) else params.grad)


def _require(tree):
    return tts_._trainable(tree, "cpu")


# ---------------------------------------------------------------------------
# T3: forward, loss, gradients
# ---------------------------------------------------------------------------

def test_t3_forward_matches_jax(t3_models):
    jp, tp = t3_models
    batch = _t3_batch()
    jc, tc = _conds(batch)
    jt, js = jt3.forward(jp, jc, *_args(batch, jnp.asarray), TINY)
    pt, ps = tt3.forward(tp, tc, *_args(batch, t), TINY)
    assert pt.shape == (4, 8, 50) and ps.shape == (4, 12, 40)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-4, rtol=1e-4)


def test_t3_loss_matches_jax(t3_models):
    jp, tp = t3_models
    batch = _t3_batch(seed=3)
    jc, tc = _conds(batch)
    jl = jt3.loss(jp, jc, *_args(batch, jnp.asarray), TINY)
    tl = tt3.loss(tp, tc, *_args(batch, t), TINY)
    for a, b in zip(tl, jl):
        assert a.dtype == torch.float32 and a.dim() == 0
        np.testing.assert_allclose(a.item(), float(b), atol=1e-5, rtol=1e-5)


def test_t3_gradients_match_jax(t3_models):
    jp, tp = t3_models
    batch = _t3_batch(seed=5)
    jgrad = jax.grad(lambda p: jts.t3_loss_fn(p, _jb(batch), TINY, jnp.float32)[0])(jp)
    params = _require(tp)
    loss, _ = tts_.t3_loss_fn(params, _tb(batch), TINY, torch.float32)
    loss.backward()
    _assert_grads_close(_grads(params), jgrad, tt3.init, TINY, "T3")
    norms = {path: g.norm().item()
             for path, g in _leaves(port_params(tt3.init, TINY, jgrad, "T3"))}
    noise = {path for path, n in norms.items() if n < 1e-6}
    assert noise == set(ZERO_GRAD_LEAVES), noise
    assert min(n for path, n in norms.items() if path not in noise) > 1e-4


def test_t3_remat_gives_equal_gradients(t3_models):
    _, tp = t3_models
    batch = _tb(_t3_batch(seed=6))
    out = []
    for remat in (False, True):
        params = _require(tp)
        loss, _ = tts_.t3_loss_fn(params, batch, TINY, torch.float32, remat=remat)
        loss.backward()
        out.append((loss.item(), _leaves(_grads(params))))
    assert out[0][0] == out[1][0]
    for (path, a), (_, b) in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6, msg=path)


# ---------------------------------------------------------------------------
# flow matching: loss and gradients
# ---------------------------------------------------------------------------

def _seed_dropping_a_row(rows):
    """The first JaxDraws seed whose CFG keep draw drops some rows and keeps
    others."""
    for seed in range(100):
        keep = JaxDraws(seed).flow_train(rows, (rows, 4, 8))[2] > CFM.training_cfg_rate
        if 0 < int(keep.sum()) < rows:
            return seed
    raise AssertionError("no seed drops a row")


@pytest.mark.parametrize("rows", [4, 2])
def test_compute_loss_matches_jax(flow_models, rows, monkeypatch):
    """4 rows take the port's K3 route (its plain version on the CPU), 2 the
    written-out attention; a CFG keep pattern that drops a row."""
    jp, tp = flow_models
    calls = []
    real = tflash.flash_attention
    monkeypatch.setattr(L, "flash_attention", lambda *a: calls.append(1) or real(*a))
    batch = _flow_batch(seed=rows, b=rows)
    seed = _seed_dropping_a_row(rows)
    keys = ("mel", "mu", "spks", "cond", "mask")
    want = jcfm.compute_loss(jp, jax.random.PRNGKey(seed),
                             *(jnp.asarray(batch[k]) for k in keys), CFM, DEC)
    got = tcfm.compute_loss(tp, JaxDraws(seed), *(t(batch[k]) for k in keys), CFM, DEC)
    assert got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5, rtol=1e-5)
    assert len(calls) == (DEC.n_blocks * (2 + DEC.num_mid_blocks) if rows >= 4 else 0)


@pytest.mark.parametrize("rows", [4, 2])
def test_flow_gradients_match_jax(flow_models, rows):
    jp, tp = flow_models
    batch = _flow_batch(seed=10 + rows, b=rows)
    key = jax.random.PRNGKey(7)
    jgrad = jax.grad(lambda p: jts.flow_loss_fn(p, key, _jb(batch), CFM, DEC,
                                                jnp.float32)[0])(jp)
    params = _require(tp)
    loss, _ = tts_.flow_loss_fn(params, JaxDraws(7), _tb(batch), CFM, DEC, torch.float32)
    loss.backward()
    _assert_grads_close(_grads(params), jgrad, tfd.init, DEC, "flow_decoder")


def test_flow_draws_come_from_the_draw_source():
    t_, z, keep = Draws(3, "cpu").flow_train(4, (4, 6, 8))
    assert t_.shape == (4,) and z.shape == (4, 6, 8) and keep.shape == (4,)
    again = Draws(3, "cpu").flow_train(4, (4, 6, 8))
    for a, b in zip((t_, z, keep), again):
        assert torch.equal(a, b)
    assert 0 <= float(t_.min()) and float(t_.max()) < 1


# ---------------------------------------------------------------------------
# train steps against the JAX steps on a one-device mesh
# ---------------------------------------------------------------------------

def _assert_params_close(port_tree, jax_tree, init_fn, cfg, name, steps):
    """Every leaf within 1e-5; a ZERO_GRAD_LEAVES leaf within lr a step."""
    want = port_params(init_fn, cfg, jax_tree, name)
    got = dict(_leaves(port_tree))
    for path, w in _leaves(want):
        atol = 1e-5 if path not in ZERO_GRAD_LEAVES else 2 * LR * steps
        np.testing.assert_allclose(got[path].detach().numpy(), w.numpy(), atol=atol,
                                   rtol=0, err_msg=path)


def test_t3_train_steps_match_jax(t3_models):
    jp, tp = t3_models
    batch = _t3_batch(seed=8)
    mesh = make_mesh(1)
    jstate = jts.init_t3_train_state(jp, lr=LR)
    jstep, _ = jts.make_t3_train_step(mesh, TINY, lr=LR, remat=True)
    state = tts_.init_t3_train_state(tp, lr=LR, device="cpu")
    step = tts_.make_t3_train_step(None, TINY, lr=LR, remat=True)
    for i in range(2):
        with mesh:
            jstate, jm = jstep(jstate, _jb(batch))
        state, m = step(state, batch)
        assert state.step == int(jstate.step) == i + 1 and int(m["step"]) == i
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=1e-5, rtol=1e-5)
        _assert_params_close(state.params, jstate.params, tt3.init, TINY, "T3", i + 1)
    # the caller's tree is not touched
    assert torch.equal(tp["text_head"]["w"], port_params(tt3.init, TINY, jp, "T3")
                       ["text_head"]["w"])


def test_flow_train_steps_match_jax(flow_models):
    jp, tp = flow_models
    batch = _flow_batch(seed=9)
    mesh = make_mesh(1)
    jstate = jts.init_flow_train_state(jp, lr=LR)
    jstep, _ = jts.make_flow_train_step(mesh, CFM, DEC, lr=LR)
    state = tts_.init_flow_train_state(tp, lr=LR, device="cpu")
    step = tts_.make_flow_train_step(None, CFM, DEC, lr=LR)
    for i in range(2):
        with mesh:
            jstate, jm = jstep(jstate, jax.random.PRNGKey(i), _jb(batch))
        state, m = step(state, JaxDraws(i), batch)
        assert state.step == int(jstate.step) == i + 1
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), atol=1e-5, rtol=1e-5)
        _assert_params_close(state.params, jstate.params, tfd.init, DEC, "flow_decoder",
                             i + 1)


def test_a_mesh_is_refused(t3_models):
    """A mesh that is not a parallel.Mesh is refused (a Mesh runs the steps
    on every rank: tests/test_torch_parallel_train.py); mesh None makes
    the optimizer anew over the same tree."""
    _, tp = t3_models
    state = tts_.init_t3_train_state(tp, device="cpu")
    for make in (lambda m: tts_.make_t3_train_step(m, TINY),
                 lambda m: tts_.make_flow_train_step(m, CFM, DEC),
                 lambda m: tts_.shard_t3_state(state, m),
                 lambda m: tts_.shard_flow_state(state, m)):
        with pytest.raises(TypeError, match="mesh must be None or a parallel.Mesh"):
            make(object())
    fresh = tts_.shard_t3_state(state, None, lr=3e-4)
    assert fresh.params is state.params and fresh.opt_state is not state.opt_state
    assert fresh.opt_state.param_groups[0]["lr"] == 3e-4


# ---------------------------------------------------------------------------
# K3's backward: the plain version of K3b
# ---------------------------------------------------------------------------

def _attn_case(seed, b, tlen, h, lens, dtype):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, tlen, h, 64)).astype(np.float32) for _ in range(4))
    valid = np.arange(tlen)[None, :] < np.asarray(lens)[:, None]
    return [t(x, dtype) for x in (q, k, v, g)], t(valid)


def _close(got, want, dtype):
    scale = max(want.float().abs().max().item(), 1.0)
    rel = 1e-5 if dtype == torch.float32 else 3e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * scale, f"max|err| {err:.3e} > {rel} * {scale:.3e}"


CASES = st.integers(1, 3).flatmap(lambda b: st.tuples(
    st.just(b), st.integers(1, 40), st.integers(1, 3),
    st.lists(st.floats(0.0, 1.0), min_size=b, max_size=b), st.integers(0, 2 ** 16)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@settings(max_examples=12, deadline=None)
@given(case=CASES)
def test_backward_reference_matches_torch_autograd(dtype, case):
    b, tlen, h, fracs, seed = case
    lens = [max(1, int(round(f * tlen))) for f in fracs]
    (q, k, v, g), valid = _attn_case(seed, b, tlen, h, lens, dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = L.mha(*leaves, mask=valid[:, None, None, :])
    out.backward(g)
    ref = tbwd.flash_attention_backward_reference(q, k, v, valid, out.detach(), g)
    for mine, leaf in zip(ref, leaves):
        assert mine.dtype == dtype
        _close(mine, leaf.grad, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@settings(max_examples=12, deadline=None)
@given(case=CASES)
def test_backward_reference_matches_jax_grad(dtype, case):
    b, tlen, h, fracs, seed = case
    lens = [max(1, int(round(f * tlen))) for f in fracs]
    (q, k, v, g), valid = _attn_case(seed, b, tlen, h, lens, dtype)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = [jnp.asarray(x.float().numpy()).astype(jd) for x in (q, k, v, g)]
    jmask = jnp.asarray(valid.numpy())[:, None, None, :]
    out, vjp = jax.vjp(lambda q_, k_, v_: jlayers.mha(q_, k_, v_, mask=jmask), *jx[:3])
    jgrads = vjp(jx[3])
    ref = tbwd.flash_attention_backward_reference(
        q, k, v, valid, t(np.asarray(out.astype(jnp.float32)), dtype), g)
    for mine, want in zip(ref, jgrads):
        _close(mine, t(np.asarray(want.astype(jnp.float32))), dtype)


def test_row_without_a_valid_key_gets_zero_gradients():
    (q, k, v, g), valid = _attn_case(1, 3, 20, 2, [20, 0, 7], torch.float32)
    out = tflash.flash_attention_reference(q, k, v, valid)
    dq, dk, dv = tbwd.flash_attention_backward_reference(q, k, v, valid, out, g)
    for x in (dq, dk, dv):
        assert torch.isfinite(x).all() and not x[1].any()
    assert dq[0].abs().sum() > 0 and dk[2, 7:].abs().sum() == 0 and dv[2, :7].abs().sum() > 0


def test_flash_attention_is_differentiable_and_saves_only_under_grad():
    """With grad, the wrapper's output has K3b as its backward (its plain
    version on the CPU) and saves q, k, v, key_valid, the output and K3's
    lse; under no_grad, or with no input that requires grad, it saves
    nothing."""
    (q, k, v, g), valid = _attn_case(2, 2, 30, 2, [30, 17], torch.float32)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tflash.flash_attention(*leaves, valid)
    assert out.grad_fn is not None and len(out.grad_fn.saved_tensors) == 6
    assert torch.equal(out.grad_fn.saved_tensors[5], tflash.lse_reference(q, k, valid))
    out.backward(g)
    ref = tbwd.flash_attention_backward_reference(q, k, v, valid, out.detach(), g)
    for mine, leaf in zip(ref, leaves):
        assert torch.equal(mine, leaf.grad)
    with torch.no_grad():
        assert tflash.flash_attention(*leaves, valid).grad_fn is None
    assert tflash.flash_attention(q, k, v, valid).grad_fn is None
    assert tflash.flash_attention.launches == 0
    assert tbwd.flash_attention_backward.launches_dq == 0
    assert tbwd.flash_attention_backward.launches_dkv == 0


def test_backward_wrapper_takes_the_plain_version_on_the_cpu():
    (q, k, v, g), valid = _attn_case(4, 2, 9, 1, [9, 4], torch.float32)
    out = tflash.flash_attention_reference(q, k, v, valid)
    got = tbwd.flash_attention_backward(q, k, v, valid, out, g,
                                        tflash.lse_reference(q, k, valid))
    want = tbwd.flash_attention_backward_reference(q, k, v, valid, out, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(dtype):
    g = torch.Generator().manual_seed(0)

    def make(*shape):
        if dtype == torch.int32:
            return torch.randint(-1000, 1000, shape, generator=g, dtype=torch.int32)
        return torch.randn(shape, generator=g).to(dtype)
    return {"llama": {"layers": [{"q": {"w": make(4, 6)}, "ln1": {"scale": make(4)}}
                                 for _ in range(3)], "norm": {"scale": make(4)}},
            "emb": {"w": make(5, 4)}, "scalar": make()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int32])
def test_checkpoint_round_trip_is_bit_exact(tmp_path, dtype):
    tree = _tree(dtype)
    path = str(tmp_path / "params.safetensors")
    tckpt.save_params(path, tree)
    back = tckpt.load_params(path)
    assert [p for p, _ in _leaves(back)] == [p for p, _ in _leaves(tree)]
    for (path_, a), (_, b) in zip(_leaves(back), _leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape, path_
        assert torch.equal(a.view(torch.uint8) if a.dim() else a, b.view(torch.uint8)
                           if b.dim() else b), path_
    like = tckpt.load_params(path, like=tree)
    assert torch.equal(like["llama"]["layers"][2]["q"]["w"], tree["llama"]["layers"][2]["q"]["w"])
    flat = tw.read_safetensors(path)[0]
    assert "llama.layers.1.q.w" in flat and "emb.w" in flat


def test_checkpoint_files_are_read_by_safetensors_readers(tmp_path):
    """fp32, int and bf16 leaves through utils/weights.load_safetensors (the
    port's numpy reader, bf16 widened to fp32 exactly), and bf16 also
    through the safetensors package's torch reader."""
    from safetensors.torch import load_file
    path = str(tmp_path / "mixed.safetensors")
    tree = {"f": _tree(torch.float32), "i": _tree(torch.int32)}
    tckpt.save_params(path, tree)
    sd = tw.load_safetensors(path)
    assert sd["f.llama.layers.2.q.w"].dtype == np.float32
    np.testing.assert_array_equal(sd["i.emb.w"], tree["i"]["emb"]["w"].numpy())
    np.testing.assert_array_equal(sd["f.scalar"], tree["f"]["scalar"].numpy())
    bpath = str(tmp_path / "bf16.safetensors")
    btree = _tree(torch.bfloat16)
    tckpt.save_params(bpath, btree)
    loaded = load_file(bpath)
    assert torch.equal(loaded["llama.layers.0.q.w"], btree["llama"]["layers"][0]["q"]["w"])
    assert loaded["emb.w"].dtype == torch.bfloat16
    widened = tw.load_safetensors(bpath)
    assert widened["emb.w"].dtype == np.float32
    np.testing.assert_array_equal(widened["emb.w"], btree["emb"]["w"].float().numpy())


def test_load_params_checks_the_target_shapes(tmp_path):
    path = str(tmp_path / "p.safetensors")
    tckpt.save_params(path, {"a": torch.zeros(3), "b": [torch.ones(2, 2)]})
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_params(path, like={"a": torch.zeros(4), "b": [torch.ones(2, 2)]})
    with pytest.raises(KeyError, match="lacks"):
        tckpt.load_params(path, like={"a": torch.zeros(3), "c": torch.zeros(1)})


def test_convert_reference_checkpoints(tmp_path):
    """A reference-format voice-encoder state dict, written here with the
    safetensors package, converts to the port's tree; absent files are
    skipped."""
    from safetensors.numpy import save_file
    rng = np.random.default_rng(0)
    hid, n_in = 8, 5
    sd = {}
    for i in range(3):
        sd[f"lstm.weight_ih_l{i}"] = rng.standard_normal((4 * hid, n_in if i == 0 else hid))
        sd[f"lstm.weight_hh_l{i}"] = rng.standard_normal((4 * hid, hid))
        sd[f"lstm.bias_ih_l{i}"] = rng.standard_normal(4 * hid)
        sd[f"lstm.bias_hh_l{i}"] = rng.standard_normal(4 * hid)
    sd["proj.weight"] = rng.standard_normal((6, hid))
    sd["proj.bias"] = rng.standard_normal(6)
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    src, out = tmp_path / "ref", tmp_path / "out"
    src.mkdir()
    save_file(sd, str(src / "ve.safetensors"))
    assert tckpt.convert_reference_checkpoints(str(src), str(out)) == ["ve"]
    assert sorted(os.listdir(out)) == ["ve.safetensors"]
    got = tckpt.load_params(str(out / "ve.safetensors"))
    want = tw.convert_voice_encoder(sd)
    assert len(got["lstm"]) == 3
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("CHATTERBOX_PROFILE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with tprof.trace("quiet"):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_trace_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("CHATTERBOX_PROFILE_DIR", str(tmp_path / "prof"))
    with tprof.trace("step"):
        with tprof.span("inner"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].startswith("step-") and files[0].endswith(".json")
    text = (tmp_path / "prof" / files[0]).read_text()
    assert '"chatterbox.inner"' in text and '"chatterbox.step"' in text

