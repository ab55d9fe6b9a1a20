"""What the DeepSeek-V2 T3 configuration is built from: its port config and
its weights, drawn from the run's seed.

The configuration's t3.backbone holds the published config.json's keys;
the port reads them through `deepseek_v2.from_hf_config`. At 15.3 B
backbone parameters one flat fp32 buffer (lib/model.py's draw) would take
61 GB, so T3's leaves are drawn one at a time: each from a generator
seeded by (seed, the leaf's path), uniform at lib/model.py's spread (the
routed experts' fan-in is their input width), rounded to bfloat16. The
program gets them in the served dtype; the reference gets the same values
widened to fp32, one backbone layer at a time (`reference_layer`). S3Gen's
weights are lib/model.py's, as chatterbox-tts draws them.
"""
from __future__ import annotations

import hashlib
import math

import torch

from . import model


def _s3gen_view(cfg: dict) -> dict:
    """The configuration as lib/model.py reads it for S3Gen's layout: T3's
    keys without the backbone, and a default Llama that no part builds."""
    t3 = {k: v for k, v in cfg["t3"].items() if k != "backbone"}
    return dict(cfg, t3=dict(t3, llama={}))


def backbone(cfg: dict):
    from chatterbox_embed_tpu_torch.models import deepseek_v2
    return deepseek_v2.from_hf_config(cfg["t3"]["backbone"])


def port_config(cfg: dict):
    """The port's ChatterboxConfig: T3 on the DeepSeek-V2 backbone."""
    from chatterbox_embed_tpu_torch import config as C
    t3 = {k: v for k, v in cfg["t3"].items() if k != "backbone"}
    base = model.port_config(_s3gen_view(cfg))
    return C.ChatterboxConfig(t3=C.T3Config(**t3, llama=backbone(cfg)), s3gen=base.s3gen)


def t3_layout(cfg: dict) -> dict:
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.models import t3 as t3_mod
    return t3_mod.init(L.Init(device="meta"), port_config(cfg).t3)


def _rule(path, shape, siblings) -> tuple:
    if "experts" in path:
        return "uniform", math.sqrt(3.0 / shape[1]), 0.0          # (E, in, out)
    return model._rule(path, shape, siblings)


def _leaf_seed(seed: int, path) -> int:
    key = f"{int(seed)}/" + "/".join(map(str, path))
    return int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little") % (2 ** 63)


def _draw(path, t, parent, seed: int, device, dtype):
    kind, bound, shift = _rule(path, tuple(t.shape), parent if isinstance(parent, dict) else {})
    if kind == "ones":
        return torch.ones(t.shape, device=device, dtype=dtype)
    if kind == "zeros":
        return torch.zeros(t.shape, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(_leaf_seed(seed, path))
    v = torch.empty(t.shape, device=device).uniform_(-1.0, 1.0, generator=gen)
    return v.mul_(bound).add_(shift).to(torch.bfloat16).to(dtype)


def _tree(layout, seed, device, served: bool, wdtype, keep=lambda path: True, prefix=()):
    out: dict = {}
    for path, t in model._leaves(layout):
        path = prefix + path
        if not keep(path):
            continue
        parent = model._get(layout, path[len(prefix):-1])
        is_w = path[-1] == "w" and len(t.shape) >= 2
        model._put(out, path[len(prefix):],
                   _draw(path, t, parent, seed, device,
                         wdtype if (served and is_w) else torch.float32))
    return out


def make_t3(cfg: dict, seed: int, device, served: bool = True, layers: bool = True) -> dict:
    """T3's tree from the seed; without `layers` the backbone keeps only its
    final norm (the reference takes its layers one at a time)."""
    keep = (lambda path: True) if layers else (lambda path: path[1:2] != ("layers",))
    return _tree(t3_layout(cfg), seed, device, served, model.DTYPES[cfg["dtype"]], keep,
                 prefix=())


def reference_layer(cfg: dict, seed: int, device, i: int) -> dict:
    """Backbone layer i in fp32 (the same values the program was handed)."""
    layout = t3_layout(cfg)["llama"]["layers"][i]
    return _tree(layout, seed, device, False, torch.float32, prefix=("llama", "layers", i))


def make_weights(cfg: dict, seed: int, device, served: bool = True) -> dict:
    """{"t3": T3's tree, "s3gen": {"flow", "hift"}} from the seed."""
    s3 = model.make_weights(_s3gen_view(cfg), ("flow", "hift"), seed, device, served)
    return {"t3": make_t3(cfg, seed, device, served), "s3gen": s3["s3gen"]}
