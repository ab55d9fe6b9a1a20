"""The port's parameter plumbing: `weights.from_jax_params` over the new
subtrees (the CAMPPlus speaker encoder and the S3 tokenizer inside S3Gen,
the voice encoder as a third tree), and the port's own checkpoint converters
(`utils/weights.py`, which write the port's layout directly) against the JAX
package's converters followed by `from_jax_params`: layer helper by layer
helper on random arrays, and the wiring functions line for line."""
import numpy as np
import pytest
import torch
import jax

from chatterbox_embed_tpu.models import s3gen as js3gen
from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu.models import voice_encoder as jve
from chatterbox_embed_tpu.utils import weights as jw
from chatterbox_embed_tpu_torch.utils import weights as tw
from chatterbox_embed_tpu_torch.weights import (FP32_S3GEN, _leaves, from_arrays,
                                                from_jax_params, place)
from test_torch_conditioning import CFG


@pytest.fixture(scope="module")
def trees():
    k = jax.random.split(jax.random.PRNGKey(0), 3)
    return (jt3.init(k[0], CFG.t3), js3gen.init(k[1], CFG.s3gen),
            jve.init(k[2], CFG.voice_encoder))


def _edit(tree, path, fn):
    """A copy of `tree` with the node at `path` (keys and indices) replaced
    by fn(node); fn returning None deletes it."""
    key, rest = path[0], path[1:]
    out = dict(tree) if isinstance(tree, dict) else list(tree)
    new = _edit(tree[key], rest, fn) if rest else fn(tree[key])
    if new is None:
        del out[key]
    else:
        out[key] = new
    return out


def test_new_subtrees_convert_with_their_layouts(trees):
    t3p, s3p, vep = trees
    state = from_jax_params(t3p, s3p, CFG, ve_params=vep)
    assert set(state) == {"t3", "s3gen", "ve"}
    assert set(state["s3gen"]) == {"flow", "hift", "speaker_encoder", "tokenizer"}
    # conv2d: JAX (kh, kw, in, out) -> torch (out, in, kh, kw)
    jw_ = np.asarray(s3p["speaker_encoder"]["fcm"]["conv1"]["w"])
    tw_ = state["s3gen"]["speaker_encoder"]["fcm"]["conv1"]["w"].numpy()
    assert jw_.shape == (3, 3, 1, 32) and tw_.shape == (32, 1, 3, 3)
    np.testing.assert_array_equal(tw_, jw_.transpose(3, 2, 0, 1))
    # depthwise conv1d: JAX (width, 1, d) -> torch (d, 1, width)
    jf = np.asarray(s3p["tokenizer"]["blocks"][0]["fsmn"]["w"])
    tf = state["s3gen"]["tokenizer"]["blocks"][0]["fsmn"]["w"].numpy()
    np.testing.assert_array_equal(tf, jf.transpose(2, 1, 0))
    # the LSTM keeps the JAX layout
    np.testing.assert_array_equal(state["ve"]["lstm"][1]["wi"].numpy(),
                                  np.asarray(vep["lstm"][1]["wi"]))
    assert "ve" not in from_jax_params(t3p, s3p, CFG)
    # every JAX leaf has its place
    n_jax = sum(1 for tree in (t3p, s3p, vep) for _ in _leaves(tree))
    assert sum(1 for tree in state.values() for _ in _leaves(tree)) == n_jax


MISSING = [("s3gen", ("speaker_encoder", "fcm", "layer1", 0, "sc_bn", "mean"), "sc_bn"),
           ("s3gen", ("tokenizer", "blocks", 0, "fsmn"), "fsmn"),
           ("s3gen", ("tokenizer",), "tokenizer"),
           ("ve", ("lstm", 2, "bh"), "bh")]


@pytest.mark.parametrize("which,path,word", MISSING)
def test_missing_leaves_raise(trees, which, path, word):
    t3p, s3p, vep = trees
    broken = {"s3gen": s3p, "ve": vep}
    broken[which] = _edit(broken[which], path, lambda node: None)
    with pytest.raises(KeyError, match=word):
        from_jax_params(t3p, broken["s3gen"], CFG, ve_params=broken["ve"])


MISSHAPEN = [("s3gen", ("speaker_encoder", "tdnn", "conv", "w")),
             ("s3gen", ("speaker_encoder", "head", "dense_bn", "var")),
             ("s3gen", ("tokenizer", "fsq_proj", "w")),
             ("ve", ("lstm", 0, "wi")), ("ve", ("proj", "b"))]


@pytest.mark.parametrize("which,path", MISSHAPEN)
def test_misshapen_leaves_raise(trees, which, path):
    t3p, s3p, vep = trees
    broken = {"s3gen": s3p, "ve": vep}
    broken[which] = _edit(broken[which], path, lambda a: np.asarray(a)[..., :-1])
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(t3p, broken["s3gen"], CFG, ve_params=broken["ve"])


UNUSED = [("s3gen", ("speaker_encoder", "blocks", 0, "layers", 0)),
          ("s3gen", ("tokenizer", "blocks", 0)), ("ve", ("proj",)), ("ve", ())]


@pytest.mark.parametrize("which,path", UNUSED)
def test_unused_leaves_raise(trees, which, path):
    t3p, s3p, vep = trees
    broken = {"s3gen": s3p, "ve": vep}
    add = lambda node: dict(node, extra={"w": np.zeros((2, 2), np.float32)})   # noqa: E731
    broken[which] = _edit(broken[which], path, add) if path else add(broken[which])
    with pytest.raises(ValueError, match="no place in the port"):
        from_jax_params(t3p, broken["s3gen"], CFG, ve_params=broken["ve"])
    # a list of the wrong length is drift too
    if which == "ve" and not path:
        with pytest.raises(ValueError, match="list of 3"):
            from_jax_params(t3p, s3p, CFG, ve_params=dict(vep, lstm=list(vep["lstm"])[:2]))


def test_place_keeps_the_conditioning_encoders_fp32(trees):
    t3p, s3p, vep = trees
    state = from_jax_params(t3p, s3p, CFG, ve_params=vep)
    placed = place(state["s3gen"], "cpu", torch.bfloat16, fp32=FP32_S3GEN)
    assert placed["flow"]["encoder_proj"]["w"].dtype == torch.bfloat16
    assert placed["flow"]["encoder_proj"]["b"].dtype == torch.float32
    for sub in FP32_S3GEN:
        assert {x.dtype for _, x in _leaves(placed[sub])} == {torch.float32}


# ---------------------------------------------------------------------------
# the port's checkpoint converters against the JAX package's
# ---------------------------------------------------------------------------

def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}{k}/")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}{i}/")
    else:
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)


def _relayout(jax_leaf_dict):
    """The layout rule of weights.from_jax_params on one converted layer."""
    out = {}
    for k, a in jax_leaf_dict.items():
        a = np.asarray(a)
        if k == "w" and a.ndim == 3:
            a = a.transpose(2, 1, 0)
        elif k == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        out[k] = a
    return out


HELPERS = [("_lin", {"p.weight": (6, 4), "p.bias": (6,)}),
           ("_conv1d", {"p.weight": (6, 4, 3), "p.bias": (6,)}),
           ("_conv1d", {"p.weight": (6, 1, 7)}),                       # depthwise, no bias
           ("_conv1d_wn", {"p.parametrizations.weight.original0": (6, 1, 1),
                           "p.parametrizations.weight.original1": (6, 4, 3), "p.bias": (6,)}),
           ("_convt1d_wn", {"p.parametrizations.weight.original0": (4, 1, 1),
                            "p.parametrizations.weight.original1": (4, 6, 5), "p.bias": (6,)}),
           ("_conv2d", {"p.weight": (6, 4, 3, 3)}),
           ("_ln", {"p.weight": (6,), "p.bias": (6,)}),
           ("_bn", {"p.running_mean": (6,), "p.running_var": (6,), "p.weight": (6,),
                    "p.bias": (6,)}),
           ("_bn", {"p.running_mean": (6,), "p.running_var": (6,)}),   # affine=False
           ("_emb", {"p.weight": (9, 4)})]


@pytest.mark.parametrize("helper,shapes", HELPERS)
def test_converter_helpers_write_the_port_layout(helper, shapes):
    """Each layer converter of the port's utils/weights.py gives what the JAX
    package's gives after from_jax_params' layout change, bit for bit (the
    weight-norm folds included)."""
    rng = np.random.default_rng(len(shapes) + len(helper))
    sd = {k: rng.standard_normal(shape).astype(np.float32) for k, shape in shapes.items()}
    want = _relayout(getattr(jw, helper)(sd, "p"))
    got = getattr(tw, helper)(sd, "p")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=f"{helper} {k}")
    if helper == "_convt1d_wn":
        # convert_hift takes the bias width from w.shape[1] in both layouts
        assert got["w"].shape == (4, 6, 5) and got["w"].shape[1] == 6


WIRING = ["_convert_validated", "convert_llama", "convert_voice_encoder", "convert_t3",
          "_conformer_block", "convert_conformer", "_causal_block", "_resnet1d", "_tblock",
          "convert_flow_decoder", "_hift_resblock", "convert_hift", "convert_campplus",
          "convert_s3tokenizer", "convert_s3gen", "load_safetensors"]


@pytest.mark.parametrize("name", WIRING)
def test_converter_wiring_is_the_jax_packages(name, tmp_path):
    """The port's copy changes the layer helpers only: the functions that
    map checkpoint names onto the tree are the JAX package's, line for
    line, so with the helpers (above) the two converters build the same
    trees. The reader is the port's own (no safetensors package): it gives
    what the JAX package's reader gives, dtype for dtype."""
    import inspect
    if name == "load_safetensors":
        from safetensors.numpy import save_file
        rng = np.random.default_rng(3)
        sd = {"f32": rng.standard_normal((3, 5)).astype(np.float32),
              "f16": rng.standard_normal(7).astype(np.float16),
              "f64": rng.standard_normal((2, 2, 2)),
              "i64": rng.integers(-9, 9, (4,)), "i8": rng.integers(-9, 9, (2, 3)).astype(np.int8),
              "u8": rng.integers(0, 255, (5,)).astype(np.uint8),
              "bool": rng.random(6) > 0.5, "empty": np.zeros((0, 4), np.float32)}
        path = str(tmp_path / "ref.safetensors")
        save_file(sd, path)
        got, want = tw.load_safetensors(path), jw.load_safetensors(path)
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        return
    assert inspect.getsource(getattr(tw, name)) == inspect.getsource(getattr(jw, name))
    if name == "convert_s3gen":
        for const in ("S3GEN_IGNORED_KEYS", "T3_IGNORED_KEYS", "VE_IGNORED_KEYS"):
            assert getattr(tw, const) == getattr(jw, const)


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_arrays(v) for v in tree]
    return tree.numpy()


def test_from_arrays_checks_the_port_layout(trees):
    t3p, s3p, vep = trees
    state = from_jax_params(t3p, s3p, CFG, ve_params=vep)
    again = from_arrays(_arrays(state["t3"]), _arrays(state["s3gen"]), CFG,
                        ve_params=_arrays(state["ve"]))
    _assert_trees_equal(again, state)
    # a JAX-layout tree given as if it were the port's is refused by its shapes
    with pytest.raises(ValueError, match="shape"):
        from_arrays(t3p, s3p, CFG)
    with pytest.raises(ValueError, match="not consumed"):
        tw.convert_voice_encoder({"stray": np.zeros(3, np.float32), **{
            f"lstm.{n}_l{i}": np.zeros((4, 4), np.float32)
            for i in range(3) for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")},
            "proj.weight": np.zeros((4, 4), np.float32), "proj.bias": np.zeros(4, np.float32)})


def test_vc_from_local_reads_the_port_converters(trees, tmp_path, monkeypatch):
    """ChatterboxVC.from_local: s3gen.safetensors through the port's
    converters; T3, voice encoder, tokenizer and conds.pt only when their
    files exist. The converters are stubbed to hand back trees in the
    port's layout (no reference checkpoint exists here)."""
    from chatterbox_embed_tpu_torch.vc import ChatterboxVC
    t3p, s3p, vep = trees
    state = from_jax_params(t3p, s3p, CFG, ve_params=vep)
    read = []
    monkeypatch.setattr(tw, "load_safetensors", lambda p: read.append(p.rsplit("/", 1)[-1]) or {})
    monkeypatch.setattr(tw, "convert_s3gen", lambda sd, cfg: _arrays(state["s3gen"]))
    monkeypatch.setattr(tw, "convert_t3", lambda sd, num_layers: _arrays(state["t3"]))
    monkeypatch.setattr(tw, "convert_voice_encoder", lambda sd: _arrays(state["ve"]))
    (tmp_path / "s3gen.safetensors").write_bytes(b"")
    vc = ChatterboxVC.from_local(tmp_path, config=CFG, device="cpu")
    assert read == ["s3gen.safetensors"]
    assert vc.t3_params is None and vc.ve_params is None and vc.tokenizer is None
    assert vc.ref_dict is None
    (tmp_path / "ve.safetensors").write_bytes(b"")
    (tmp_path / "t3_cfg.safetensors").write_bytes(b"")
    vc = ChatterboxVC.from_local(tmp_path, config=CFG, device="cpu")
    assert read[1:] == ["s3gen.safetensors", "t3_cfg.safetensors", "ve.safetensors"]
    _assert_trees_equal(vc.ve_params, state["ve"])
    assert len(vc.t3_params["llama"]["layers"]) == CFG.t3.llama.num_layers
