"""The JAX package's parameter trees -> the port's parameter trees.

`from_jax_params` takes the trees that `chatterbox_embed_tpu` builds (its
`init` functions, or `utils.weights.convert_t3` / `convert_s3gen` on a
reference checkpoint), as numpy arrays, and returns the port's trees as fp32
CPU tensors. The port's tree has the same nesting and leaf names. Layout
changes, all of them:

- conv1d "w": JAX (width, in/groups, out) -> torch (out, in/groups, width)
  for F.conv1d, i.e. permute(2, 1, 0);
- transposed conv "w" (HiFT "ups"): JAX (width, out, in) -> torch
  (in, out, width) for F.conv_transpose1d, the same permute(2, 1, 0);
- everything else unchanged: linear "w" stays (in, out) (the port computes
  x @ w, as JAX does), embeddings stay (vocab, dim), norms, biases and the
  other vectors keep their shapes.

Every leaf of the port's expected tree (its `init` on the meta device) must
exist in the JAX tree with the expected shape after the layout change, and
every JAX leaf must be consumed: a missing or unused leaf raises, in the
spirit of the JAX package's `_convert_validated`. The only JAX subtrees left
out on purpose are the conditioning encoders this port does not carry yet
(`SKIPPED_S3GEN`).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ChatterboxConfig
from .models import layers as L
from .models import s3gen, t3

SKIPPED_S3GEN = ("speaker_encoder", "tokenizer")   # CAMPPlus, S3 tokenizer


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _convert(expected, src, path=""):
    """Walk the expected tree; return the converted tree and the source
    leaf paths consumed."""
    if isinstance(expected, dict):
        if not isinstance(src, dict):
            raise TypeError(f"{path or '<root>'}: expected a dict, got {type(src).__name__}")
        out = {}
        for k, v in expected.items():
            if k not in src:
                raise KeyError(f"JAX params missing {path}{k} (have: {sorted(src)})")
            out[k] = _convert(v, src[k], f"{path}{k}/")
        return out
    if isinstance(expected, list):
        if not isinstance(src, (list, tuple)) or len(src) != len(expected):
            raise ValueError(f"{path}: expected a list of {len(expected)}, got "
                             f"{type(src).__name__} of {len(src) if hasattr(src, '__len__') else '?'}")
        return [_convert(e, s, f"{path}{i}/") for i, (e, s) in enumerate(zip(expected, src))]
    a = np.array(src, np.float32)          # a copy: jax arrays are read-only
    if path.endswith("/w/") and a.ndim == 3:
        a = a.transpose(2, 1, 0)
    if tuple(a.shape) != tuple(expected.shape):
        raise ValueError(f"{path[:-1]}: shape {tuple(a.shape)} after the layout change, "
                         f"expected {tuple(expected.shape)}")
    return torch.from_numpy(np.ascontiguousarray(a))


def convert_tree(expected, src, name: str, skip=()):
    """Convert the JAX tree `src` to the layout of the port's `expected`
    tree; raises on a missing, misshapen or unused leaf. `skip` names
    top-level JAX subtrees left out on purpose."""
    src = {k: v for k, v in src.items() if k not in skip}
    out = _convert(expected, src)
    want = {p for p, _ in _leaves(expected)}
    unused = sorted(p for p, _ in _leaves(src) if p not in want)
    if unused:
        raise ValueError(f"{len(unused)} {name} parameters have no place in the port "
                         f"(architecture drift, or int8 weights?): {unused[:20]}")
    return out


def from_jax_params(t3_params, s3gen_params, config: ChatterboxConfig = ChatterboxConfig()):
    """JAX T3 and S3Gen parameter trees (numpy or jax arrays) -> the port's
    {"t3": tree, "s3gen": tree} of fp32 CPU tensors (layouts above)."""
    meta = L.Init(device="meta")
    return {
        "t3": convert_tree(t3.init(meta, config.t3), t3_params, "T3"),
        "s3gen": convert_tree(s3gen.init(meta, config.s3gen), s3gen_params,
                                    "S3Gen", skip=SKIPPED_S3GEN),
    }


def place(tree, device, dtype):
    """Copy a parameter tree to `device`: matmul, conv and embedding weights
    (leaves named "w" with >= 2 dims) in `dtype`, every other leaf fp32."""
    def go(x, name):
        if isinstance(x, dict):
            return {k: go(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [go(v, name) for v in x]
        want = dtype if name == "w" and x.dim() >= 2 else torch.float32
        return x.to(device=device, dtype=want)
    return go(tree, "")
