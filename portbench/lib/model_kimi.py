"""What the Kimi-Linear T3 configuration is built from: its port config and
its weights, drawn from the run's seed.

The configuration's t3.backbone holds the published config.json's keys,
with `num_experts` the experts this card holds (0 .. num_experts - 1) and
`published_num_experts` the router's width; the port reads them through
`kimi_linear.from_hf_config`. T3's leaves are drawn one at a time, as
lib/model_dsv2.py draws them: each from a generator seeded by (seed, the
leaf's path), uniform at lib/model.py's spread (the routed experts' fan-in
is their input width), rounded to bfloat16; KDA's own leaves as fla's
KimiDeltaAttention draws them (the configuration's `assumed`): A_log =
log(U(1, 16)), dt_bias the inverse softplus of a log-uniform dt in [0.001,
0.1], the short conv's taps at fan-in 4; the router's correction bias
uniform in +-0.05. The program gets the matrices in the served dtype and
the rest in fp32; the reference gets the same values widened to fp32, one
backbone layer at a time (`reference_layer`). S3Gen's weights are
lib/model.py's, as chatterbox-tts draws them.
"""
from __future__ import annotations

import math

import torch

from . import model, model_dsv2

BIAS_BOUND = 0.05


def backbone(cfg: dict):
    from chatterbox_embed_tpu_torch.models import kimi_linear
    return kimi_linear.from_hf_config(cfg["t3"]["backbone"])


def port_config(cfg: dict):
    """The port's ChatterboxConfig: T3 on the Kimi-Linear backbone."""
    from chatterbox_embed_tpu_torch import config as C
    t3 = {k: v for k, v in cfg["t3"].items() if k != "backbone"}
    base = model.port_config(model_dsv2._s3gen_view(cfg))
    return C.ChatterboxConfig(t3=C.T3Config(**t3, llama=backbone(cfg)), s3gen=base.s3gen)


def t3_layout(cfg: dict) -> dict:
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.models import t3 as t3_mod
    return t3_mod.init(L.Init(device="meta"), port_config(cfg).t3)


def _value(path, u: torch.Tensor, shape, siblings) -> torch.Tensor:
    """A leaf from u, uniform in [-1, 1] and drawn for it alone."""
    name = path[-1]
    if name == "A_log":
        return torch.log(8.5 + 7.5 * u)
    if name == "dt_bias":
        dt = torch.exp(0.5 * math.log(100.0) * u
                       + 0.5 * (math.log(0.001) + math.log(0.1))).clamp_min(1e-4)
        return dt + torch.log(-torch.expm1(-dt))
    if name == "e_score_correction_bias":
        return BIAS_BOUND * u
    if "conv" in path:
        return u / math.sqrt(shape[0])                   # (taps, channels): fan-in the taps
    kind, bound, shift = model_dsv2._rule(path, shape, siblings)
    if kind == "ones":
        return torch.ones_like(u)
    if kind == "zeros":
        return torch.zeros_like(u)
    return u * bound + shift


def _tree(layout, seed, device, served: bool, wdtype, keep=lambda path: True, prefix=()):
    out: dict = {}
    for path, t in model._leaves(layout):
        path = prefix + path
        if not keep(path):
            continue
        parent = model._get(layout, path[len(prefix):-1])
        siblings = parent if isinstance(parent, dict) else {}
        gen = torch.Generator(device=device).manual_seed(model_dsv2._leaf_seed(seed, path))
        u = torch.empty(t.shape, device=device).uniform_(-1.0, 1.0, generator=gen)
        is_w = path[-1] == "w" and len(t.shape) >= 2
        v = _value(path, u, tuple(t.shape), siblings).to(torch.bfloat16)
        model._put(out, path[len(prefix):], v.to(wdtype if (served and is_w) else torch.float32))
    return out


def make_t3(cfg: dict, seed: int, device, served: bool = True, layers: bool = True) -> dict:
    """T3's tree from the seed; without `layers` the backbone keeps only its
    final norm (the reference takes its layers one at a time)."""
    keep = (lambda path: True) if layers else (lambda path: path[1:2] != ("layers",))
    return _tree(t3_layout(cfg), seed, device, served, model.DTYPES[cfg["dtype"]], keep)


def reference_layer(cfg: dict, seed: int, device, i: int) -> dict:
    """Backbone layer i in fp32 (the same values the program was handed)."""
    layout = t3_layout(cfg)["llama"]["layers"][i]
    return _tree(layout, seed, device, False, torch.float32, prefix=("llama", "layers", i))


def make_weights(cfg: dict, seed: int, device, served: bool = True) -> dict:
    """{"t3": T3's tree, "s3gen": {"flow", "hift"}} from the seed."""
    s3 = model.make_weights(model_dsv2._s3gen_view(cfg), ("flow", "hift"), seed, device, served)
    return {"t3": make_t3(cfg, seed, device, served), "s3gen": s3["s3gen"]}
