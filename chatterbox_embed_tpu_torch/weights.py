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
        out = {}
        for k, v in expected.items():
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


def convert_tree(expected, src, name: str, relayout=True):
    """Convert the tree of arrays `src` to the port's `expected` tree of
    tensors; raises on a missing, misshapen or unused leaf. `relayout`: the
    source is in the JAX package's layout (else the port's)."""
    out = _convert(expected, src, relayout=relayout)
    want = {p for p, _ in _leaves(expected)}
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
    fp32 CPU tensors (layouts above)."""
    return _trees(t3_params, s3gen_params, ve_params, config, relayout=True)


def from_arrays(t3_params, s3gen_params, config: ChatterboxConfig = ChatterboxConfig(),
                ve_params=None):
    """Trees of numpy arrays already in the port's layout (utils/weights.py)
    -> the same dict of trees of fp32 CPU tensors, every leaf checked."""
    return _trees(t3_params, s3gen_params, ve_params, config, relayout=False)


def place(tree, device, dtype, fp32=()):
    """Copy a parameter tree to `device`: matmul, conv and embedding weights
    (leaves named "w" with >= 2 dims) in `dtype`, every other leaf fp32.
    `fp32` names top-level subtrees kept in fp32 altogether."""
    def go(x, name, dt):
        if isinstance(x, dict):
            return {k: go(v, k, dt) for k, v in x.items()}
        if isinstance(x, list):
            return [go(v, name, dt) for v in x]
        want = dt if name == "w" and x.dim() >= 2 else torch.float32
        return x.to(device=device, dtype=want)
    return {k: go(v, k, torch.float32 if k in fp32 else dtype) for k, v in tree.items()}
