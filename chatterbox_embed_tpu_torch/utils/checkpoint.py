"""Parameter checkpoints as safetensors files, the PyTorch counterpart of
`chatterbox_embed_tpu/utils/checkpoint.py` (which writes Orbax trees).

A tree (nested dicts and lists of tensors, the port's parameter layout) is
flattened by its path names ("llama.layers.0.q.w") into one safetensors
file; its shape of dicts and lists rides in the file's metadata, so
`load_params` gives the same tree back. Every leaf keeps its dtype (bf16
included) and its bytes: a round trip is bit-exact. The writer is this
module's own, the counterpart of the port's reader
(`utils/weights.read_safetensors`), so nothing beyond torch and numpy is
needed; any safetensors reader reads the files.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict

import numpy as np
import torch

from ..config import ChatterboxConfig
from . import weights as W

_CODES = {torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
          torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32",
          torch.int16: "I16", torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL"}
_TREE_KEY = "chatterbox_tree"


def _flatten(tree, prefix: str, out: Dict[str, torch.Tensor]):
    """(skeleton, out): the tree's shape with None at the leaves, and
    {path: tensor} of its leaves."""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}{k}.", out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, f"{prefix}{i}.", out) for i, v in enumerate(tree)]
    out[prefix[:-1]] = torch.as_tensor(tree)
    return None


def _unflatten(skeleton, prefix: str, flat: Dict[str, torch.Tensor]):
    if isinstance(skeleton, dict):
        return {k: _unflatten(v, f"{prefix}{k}.", flat) for k, v in skeleton.items()}
    if isinstance(skeleton, list):
        return [_unflatten(v, f"{prefix}{i}.", flat) for i, v in enumerate(skeleton)]
    return flat[prefix[:-1]]


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Dict[str, str] = None) -> None:
    """{name: tensor} -> one safetensors file (tensors copied to the host)."""
    header: Dict[str, Any] = {"__metadata__": dict(metadata)} if metadata else {}
    blobs, offset = [], 0
    for name, x in tensors.items():
        x = x.detach().to("cpu").contiguous()
        if x.dtype not in _CODES:
            raise ValueError(f"write_safetensors: {name} has dtype {x.dtype}, not one of "
                             f"{sorted(_CODES.values())}")
        blob = x.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _CODES[x.dtype], "shape": list(x.shape),
                        "data_offsets": [offset, offset + len(blob)]}
        blobs.append(blob)
        offset += len(blob)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)          # the data starts 8-byte aligned
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for blob in blobs:
            f.write(blob)
    os.replace(tmp, path)


def _tensor(array: np.ndarray, code: str) -> torch.Tensor:
    """One array of `read_safetensors` as a CPU tensor of the file's dtype."""
    if code == "BF16":
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def save_params(path: str, params: Any) -> None:
    """Save a parameter tree (tensors or numpy arrays, any device) to a
    safetensors file at `path`."""
    flat: Dict[str, torch.Tensor] = {}
    skeleton = _flatten(params, "", flat)
    write_safetensors(path, flat, {_TREE_KEY: json.dumps(skeleton)})


def load_params(path: str, like: Any = None) -> Any:
    """Restore a tree saved by `save_params`, as CPU tensors in their saved
    dtypes. `like` (a tree) gives the target structure: each leaf lands on
    the device of `like`'s leaf and must have its shape. A file without the
    tree's metadata (another writer's) gives its flat {name: tensor}."""
    arrays, codes, metadata = W.read_safetensors(path)
    flat = {name: _tensor(a, codes[name]) for name, a in arrays.items()}
    if like is not None:
        want: Dict[str, torch.Tensor] = {}
        skeleton = _flatten(like, "", want)
        missing = sorted(set(want) - set(flat))
        if missing:
            raise KeyError(f"load_params: {path} lacks {missing[:10]}")
        for name, ref in want.items():
            if tuple(flat[name].shape) != tuple(ref.shape):
                raise ValueError(f"load_params: {name} has shape {tuple(flat[name].shape)}, "
                                 f"expected {tuple(ref.shape)}")
            flat[name] = flat[name].to(ref.device)
        return _unflatten(skeleton, "", flat)
    if _TREE_KEY not in metadata:
        return flat
    return _unflatten(json.loads(metadata[_TREE_KEY]), "", flat)


def convert_reference_checkpoints(ckpt_dir: str, out_dir: str,
                                  config: ChatterboxConfig = ChatterboxConfig()) -> list:
    """One-shot conversion: the reference's ve / t3_cfg / s3gen safetensors
    in `ckpt_dir` (whichever exist) -> the port's trees, saved as
    `out_dir/{ve,t3,s3gen}.safetensors`. `config` gives the layer counts.
    Returns the names converted."""
    os.makedirs(out_dir, exist_ok=True)
    mapping = {
        "ve": ("ve.safetensors", W.convert_voice_encoder),
        "t3": ("t3_cfg.safetensors",
               lambda sd: W.convert_t3(sd, num_layers=config.t3.llama.num_layers)),
        "s3gen": ("s3gen.safetensors", lambda sd: W.convert_s3gen(sd, cfg=config.s3gen)),
    }
    done = []
    for name, (fname, converter) in mapping.items():
        src = os.path.join(ckpt_dir, fname)
        if os.path.exists(src):
            save_params(os.path.join(out_dir, f"{name}.safetensors"),
                        converter(W.load_safetensors(src)))
            done.append(name)
    return done
