"""Parameter trees of arrays -> the port's parameter trees of tensors.

`from_jax_params` takes the trees that `chatterbox_embed_tpu` builds (its
`init` functions, or its checkpoint converters), as numpy arrays, and
returns the port's trees as fp32 CPU tensors; the parity tests feed the port
this way. `from_arrays` takes trees already in the port's layout (what the
port's own converters in `utils/weights.py` produce from a reference
checkpoint). The port's tree has the JAX tree's nesting and leaf names.
Layout changes made by `from_jax_params`, all of them:

- conv1d "w": JAX (width, in/groups, out) -> torch (out, in/groups, width)
  for F.conv1d, i.e. permute(2, 1, 0);
- transposed conv "w" (HiFT "ups"): JAX (width, out, in) -> torch
  (in, out, width) for F.conv_transpose1d, the same permute(2, 1, 0);
- conv2d "w" (CAMPPlus): JAX (kh, kw, in, out) -> torch (out, in, kh, kw)
  for F.conv2d, i.e. permute(3, 2, 0, 1);
- everything else unchanged: linear "w" stays (in, out) (the port computes
  x @ w, as JAX does), embeddings stay (vocab, dim), norms, biases and the
  other vectors keep their shapes.

A linear may come quantised (the JAX package's or the port's
`utils/quantize.py`): "w_q" (in, out) int8 and "scale" (1, out) fp32 in
place of "w". They need no relayout and keep their dtypes.

Every leaf of the port's expected tree (its `init` on the meta device) must
exist in the JAX tree with the expected shape after the layout change, and
every JAX leaf must be consumed: a missing, misshapen or unused leaf raises,
in the spirit of the converters' `_convert_validated`. No subtree is left
out: the S3Gen tree carries the CAMPPlus speaker encoder and the S3
tokenizer, and the voice encoder is a third tree.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ChatterboxConfig
from .models import layers as L
from .models import s3gen, t3, voice_encoder

# S3Gen subtrees that stay fp32 whatever the compute dtype (`place`): the
# conditioning encoders, which the JAX package also runs in fp32
FP32_S3GEN = ("speaker_encoder", "tokenizer")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _convert(expected, src, path="", relayout=True):
    """Walk the expected tree; return the converted tree. `relayout` makes
    the JAX -> torch layout changes of convolution kernels."""
    if isinstance(expected, dict):
        if not isinstance(src, dict):
            raise TypeError(f"{path or '<root>'}: expected a dict, got {type(src).__name__}")
        int8 = "w" in expected and "w" not in src and "w_q" in src
        out = _int8_leaves(expected["w"], src, path) if int8 else {}
        for k, v in expected.items():
            if int8 and k == "w":
                continue
            if k not in src:
                raise KeyError(f"params missing {path}{k} (have: {sorted(src)})")
            out[k] = _convert(v, src[k], f"{path}{k}/", relayout)
        return out
    if isinstance(expected, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(expected):
            raise ValueError(f"{path}: expected a list of {len(expected)}, got "
                             f"{type(src).__name__} of {len(src) if hasattr(src, '__len__') else '?'}")
        return [_convert(e, s, f"{path}{i}/", relayout)
                for i, (e, s) in enumerate(zip(expected, src))]
    a = np.array(src, np.float32)          # a copy: jax arrays are read-only
    if relayout and path.endswith("/w/") and a.ndim == 3:
        a = a.transpose(2, 1, 0)
    elif relayout and path.endswith("/w/") and a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    if tuple(a.shape) != tuple(expected.shape):
        raise ValueError(f"{path[:-1]}: shape {tuple(a.shape)} after the layout change, "
                         f"expected {tuple(expected.shape)}")
    return torch.from_numpy(np.ascontiguousarray(a))


def _int8_leaves(w, src, path):
    """A quantised linear's w_q (int8, of w's (in, out) shape) and scale
    ((1, out) fp32) in place of w, kept in their dtypes."""
    if w.dim() != 2:
        raise ValueError(f"{path}w_q: only a linear's (in, out) weight may be int8, "
                         f"this one is {tuple(w.shape)}")
    w_q, scale = np.asarray(src["w_q"]), np.asarray(src.get("scale"))
    if w_q.dtype != np.int8 or tuple(w_q.shape) != tuple(w.shape):
        raise ValueError(f"{path}w_q: {w_q.dtype} {tuple(w_q.shape)}, expected int8 "
                         f"{tuple(w.shape)}")
    if scale.dtype != np.float32 or tuple(scale.shape) != (1, w.shape[1]):
        raise ValueError(f"{path}scale: {scale.dtype} {tuple(scale.shape)}, expected "
                         f"float32 {(1, w.shape[1])}")
    return {"w_q": torch.from_numpy(np.array(w_q)), "scale": torch.from_numpy(np.array(scale))}


def convert_tree(expected, src, name: str, relayout=True):
    """Convert the tree of arrays `src` to the port's `expected` tree of
    tensors; raises on a missing, misshapen or unused leaf (a quantised
    linear's w_q and scale stand for its w). `relayout`: the source is in
    the JAX package's layout (else the port's)."""
    out = _convert(expected, src, relayout=relayout)
    want = {p for p, _ in _leaves(out)}
    unused = sorted(p for p, _ in _leaves(src) if p not in want)
    if unused:
        raise ValueError(f"{len(unused)} {name} parameters have no place in the port "
                         f"(architecture drift, or int8 weights?): {unused[:20]}")
    return out


def _trees(t3_params, s3gen_params, ve_params, config, relayout):
    meta = L.Init(device="meta")
    out = {
        "t3": convert_tree(t3.init(meta, config.t3), t3_params, "T3", relayout),
        "s3gen": convert_tree(s3gen.init(meta, config.s3gen), s3gen_params, "S3Gen",
                              relayout),
    }
    if ve_params is not None:
        out["ve"] = convert_tree(voice_encoder.init(meta, config.voice_encoder), ve_params,
                                 "VoiceEncoder", relayout)
    return out


def from_jax_params(t3_params, s3gen_params, config: ChatterboxConfig = ChatterboxConfig(),
                    ve_params=None):
    """JAX T3, S3Gen and (optionally) VoiceEncoder parameter trees (numpy or
    jax arrays) -> the port's {"t3": tree, "s3gen": tree[, "ve": tree]} of
    fp32 CPU tensors (a quantised linear's w_q int8; layouts above)."""
    return _trees(t3_params, s3gen_params, ve_params, config, relayout=True)


def from_arrays(t3_params, s3gen_params, config: ChatterboxConfig = ChatterboxConfig(),
                ve_params=None):
    """Trees of numpy arrays already in the port's layout (utils/weights.py)
    -> the same dict of trees of fp32 CPU tensors, every leaf checked."""
    return _trees(t3_params, s3gen_params, ve_params, config, relayout=False)


def place(tree, device, dtype, fp32=()):
    """Copy a parameter tree to `device`: matmul, conv and embedding weights
    (leaves named "w" with >= 2 dims) in `dtype`, a quantised linear's "w_q"
    in int8, every other leaf (its "scale" too) fp32. `fp32` names top-level
    subtrees kept in fp32 altogether."""
    def go(x, name, dt):
        if isinstance(x, dict):
            return {k: go(v, k, dt) for k, v in x.items()}
        if isinstance(x, list):
            return [go(v, name, dt) for v in x]
        if name == "w_q":
            return x.to(device=device, dtype=torch.int8)
        want = dt if name == "w" and x.dim() >= 2 else torch.float32
        return x.to(device=device, dtype=want)
    return {k: go(v, k, torch.float32 if k in fp32 else dtype) for k, v in tree.items()}
