"""DeepSeek-V2 as T3's backbone: multi-head latent attention (MLA) and a
mixture of routed and shared experts, after the published modeling code
(deepseek-ai/DeepSeek-V2-Lite, `modeling_deepseek.py`; equations in the
DeepSeek-V2 paper, arXiv:2405.04434). T3 wraps it as it wraps Llama_520M:
its own conditioning, tables, positions and speech head; the backbone's
token table and head are not held.

- Attention (no q-LoRA): q = W_q h, 16 heads of 192 (128 without RoPE,
  64 with it); W_kva h gives the latent c (512, RMS-normed) and one k_pe
  (64) shared by the heads; W_kvb c gives each head's k_nope (128) and v
  (128). Softmax scale 192^-0.5 * mscale^2 (YaRN's mscale_all_dim). RoPE
  is YaRN (`inv_freq`), on the rope dims read as interleaved pairs and
  rotated in the half-split layout, as the published apply_rotary_pos_emb
  does.
- The cache is latent (`LatentCache`): one row a token, [norm(c); roped
  k_pe], 576 wide, shared by all heads, (layers, L, B, 576) sequence-major
  like Llama's. A block of several tokens (prefill) attends in the
  published, non-absorbed form over the cache; a single-token step attends
  absorbed: q_nope W_uk^T (512 a head) with q_pe scores the 576-wide rows
  directly, the probabilities weigh the latents, and W_uv maps the result
  to each head's v. The scores are products in the compute dtype and the
  softmax in fp32, as the published code computes them.
- Layer 0 (first_k_dense_replace) is a dense SwiGLU; the others are MoE:
  the router's fp32 softmax over the routed experts, the greedy top-k with
  weights not renormalised (x routed_scaling_factor), or with
  `scoring_func` "sigmoid" Kimi-Linear's router (models/kimi_linear.py);
  the routed experts' SwiGLU through K7 (`kernels/moe_experts.py`: rows
  sorted by expert on the device, the per-expert offsets read by the
  kernel, so a CUDA graph holds the layer whatever the routing), and the
  shared experts as one SwiGLU of n_shared x moe_intermediate_size.
- The held share (`experts_held`, [lo, hi)): the router scores every
  routed expert and keeps its top k, but the layer holds only the experts
  of its range, as one card of an expert-parallel deployment does; only
  the assignments to them reach K7 (the others sorted past the held
  offsets on the device, so no host read), and what the absent experts
  would add is left out. None holds them all: today's path, unchanged.
- The routing record: a cache may hold `route` (moe layers, L, B, top_k)
  int16, the expert ids of every row and token, written beside the latent
  row at the same columns. The device counters `moe.calls`,
  `moe.assignments`, `moe.experts_touched` and `moe.max_expert_rows` are
  added on the device while profiling is on (utils/profiling.py), once a
  forward from the MoE calls' expert counts stacked (about ten kernels a
  forward, however many layers).
- Spans `dsv2.attention`, `dsv2.route` and `dsv2.experts` wrap the eager
  calls; none opens while a CUDA graph is being captured.

The module gives T3 the face of models/backbone.py. What T3 does not run
on this backbone (`UNSUPPORTED`: the int8 cache and weights, K4, the mesh,
the stream's first-chunk graph, the alignment spy and training) raises
where it is asked for (`backbone.check`).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import constant, resolve_device
from ..kernels import moe_experts
from ..utils import profiling
from . import layers as L

# T3's face of a backbone (models/backbone.py)
NAME = "DeepSeek-V2"
UNSUPPORTED = frozenset({"int8_cache", "int8_weights", "fused_step", "mesh", "first_chunk",
                         "alignment", "training"})
WHOLE_STEP = True
SERVING_KERNELS = ("moe_experts",)


@dataclass(frozen=True)
class DeepseekV2Config:
    """DeepSeek-V2-Lite's backbone (config.json of deepseek-ai/DeepSeek-V2-Lite),
    without its 102,400-row token table and head. No q-LoRA; YaRN RoPE."""
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    max_position_embeddings: int = 163840
    scoring_func: str = "softmax"
    experts_held: Optional[Tuple[int, int]] = None      # [lo, hi); None: every expert

    @property
    def softmax_scale(self) -> float:
        return softmax_scale(self)

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """A cache row: the latent c and the shared k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace


# the published config.json's settings that this module computes as given
_FIXED = {"q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy",
          "norm_topk_prob": False, "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
          "hidden_act": "silu", "attention_bias": False}


def from_hf_config(c: dict) -> DeepseekV2Config:
    """The backbone of a published DeepSeek-V2 config.json (a dict); a
    setting this module does not compute raises."""
    for k, want in _FIXED.items():
        if c.get(k, want) != want:
            raise ValueError(f"DeepSeek-V2 config: {k}={c[k]!r} is not ported (want {want!r})")
    rs = c["rope_scaling"]
    if rs.get("type") != "yarn":
        raise ValueError(f"DeepSeek-V2 config: rope_scaling type {rs.get('type')!r}, want yarn")
    return DeepseekV2Config(
        hidden_size=c["hidden_size"], num_layers=c["num_hidden_layers"],
        num_heads=c["num_attention_heads"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"], qk_rope_head_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], intermediate_size=c["intermediate_size"],
        moe_intermediate_size=c["moe_intermediate_size"], n_routed_experts=c["n_routed_experts"],
        n_shared_experts=c["n_shared_experts"], num_experts_per_tok=c["num_experts_per_tok"],
        first_k_dense_replace=c["first_k_dense_replace"],
        routed_scaling_factor=float(c["routed_scaling_factor"]),
        rms_norm_eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]),
        rope_factor=float(rs["factor"]),
        rope_original_max_position=int(rs["original_max_position_embeddings"]),
        rope_beta_fast=float(rs["beta_fast"]), rope_beta_slow=float(rs["beta_slow"]),
        rope_mscale=float(rs["mscale"]), rope_mscale_all_dim=float(rs["mscale_all_dim"]),
        max_position_embeddings=c["max_position_embeddings"])


class LatentCache(NamedTuple):
    """(layers, L, B, latent_dim) cache rows, updated in place by `forward`;
    with the routing record, (moe layers, L, B, top_k) int16 expert ids."""
    c: torch.Tensor
    route: Optional[torch.Tensor] = None


def kv_heads(params, cfg: DeepseekV2Config) -> int:
    """One cache row a token, shared by every head."""
    return 1


def init_cache(cfg: DeepseekV2Config, batch: int, max_len: int, dtype=torch.float32,
               device=None, heads: Optional[int] = None, route: bool = False) -> LatentCache:
    """Zero (layers, max_len, batch, latent_dim) rows in `dtype` (the heads
    share them: `heads` is not read), and with `route` the zero routing
    record."""
    device = resolve_device(device)
    c = torch.zeros((cfg.num_layers, max_len, batch, cfg.latent_dim), dtype=dtype, device=device)
    rec = None
    if route:
        rec = torch.zeros((cfg.moe_layers, max_len, batch, cfg.num_experts_per_tok),
                          dtype=torch.int16, device=device)
    return LatentCache(c, rec)


def cache_bytes_per_token(cfg: DeepseekV2Config, dtype=torch.bfloat16,
                          int8: bool = False) -> int:
    """One latent row a token and layer, shared by the heads (no int8 cache:
    backbone.check refuses it)."""
    return cfg.num_layers * cfg.latent_dim * torch.empty((), dtype=dtype).element_size()


def _swiglu_init(init: L.Init, d: int, f: int):
    return {"gate": L.linear_init(init, d, f, bias=False), "up": L.linear_init(init, d, f, bias=False),
            "down": L.linear_init(init, f, d, bias=False)}


def init(init: L.Init, cfg: DeepseekV2Config = DeepseekV2Config()):
    d, h = cfg.hidden_size, cfg.num_heads
    lo, hi = held_range(cfg)
    e, f = hi - lo, cfg.moe_intermediate_size
    layers = []
    for i in range(cfg.num_layers):
        lp = {
            "ln1": {"scale": init.ones((d,))},
            "q": L.linear_init(init, d, h * cfg.q_head_dim, bias=False),
            "kv_a": L.linear_init(init, d, cfg.latent_dim, bias=False),
            "kv_norm": {"scale": init.ones((cfg.kv_lora_rank,))},
            "kv_b": L.linear_init(init, cfg.kv_lora_rank,
                                  h * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False),
            "o": L.linear_init(init, h * cfg.v_head_dim, d, bias=False),
            "ln2": {"scale": init.ones((d,))},
        }
        if i < cfg.first_k_dense_replace:
            lp["mlp"] = _swiglu_init(init, d, cfg.intermediate_size)
        else:
            lp["router"] = L.linear_init(init, d, cfg.n_routed_experts, bias=False)
            lp["experts"] = {
                "gate": {"w": init.uniform((e, d, f), math.sqrt(3.0 / d))},
                "up": {"w": init.uniform((e, d, f), math.sqrt(3.0 / d))},
                "down": {"w": init.uniform((e, f, d), math.sqrt(3.0 / f))}}
            lp["shared"] = _swiglu_init(init, d, f * cfg.n_shared_experts)
        layers.append(lp)
    return {"layers": layers, "norm": {"scale": init.ones((d,))}}


# ---------------------------------------------------------------------------
# YaRN RoPE
# ---------------------------------------------------------------------------

def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, cfg: DeepseekV2Config) -> float:
    dim = cfg.qk_rope_head_dim
    return (dim * math.log(cfg.rope_original_max_position / (rotations * 2 * math.pi))
            / (2 * math.log(cfg.rope_theta)))


def yarn_inv_freq(cfg: DeepseekV2Config) -> np.ndarray:
    """(rope_dim / 2,) float32: the extrapolated frequencies below the
    correction range, the interpolated ones (/ factor) above it, a linear
    ramp between (the published DeepseekV2YarnRotaryEmbedding)."""
    dim = cfg.qk_rope_head_dim
    base = cfg.rope_theta ** (np.arange(0, dim, 2, dtype=np.float32) / np.float32(dim))
    extra = (1.0 / base).astype(np.float32)
    inter = (1.0 / (np.float32(cfg.rope_factor) * base)).astype(np.float32)
    low = max(math.floor(_correction_dim(cfg.rope_beta_fast, cfg)), 0)
    high = min(math.ceil(_correction_dim(cfg.rope_beta_slow, cfg)), dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - low) / (high - low), 0, 1)
    mask = (1.0 - ramp).astype(np.float32)
    return (inter * (1 - mask) + extra * mask).astype(np.float32)


def rope_scale(cfg: DeepseekV2Config) -> float:
    """The factor on cos and sin: mscale(factor, mscale) / mscale(factor,
    mscale_all_dim), 1 for DeepSeek-V2-Lite."""
    return (yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
            / yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))


def softmax_scale(cfg: DeepseekV2Config) -> float:
    m = yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) if cfg.rope_mscale_all_dim else 1.0
    return cfg.q_head_dim ** -0.5 * m * m


def rope_cos_sin(pos_ids: torch.Tensor, cfg: DeepseekV2Config):
    """pos_ids (B, T) -> cos, sin (B, T, rope_dim) fp32, half-split."""
    key = ("yarn_inv_freq", cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_factor,
           cfg.rope_original_max_position, cfg.rope_beta_fast, cfg.rope_beta_slow)
    inv = constant(key, pos_ids.device, lambda: yarn_inv_freq(cfg))
    ang = pos_ids[..., None].float() * inv
    ang = torch.cat([ang, ang], dim=-1)
    s = rope_scale(cfg)
    return torch.cos(ang) * s, torch.sin(ang) * s


def apply_rope(x, cos, sin):
    """x (B, T, H, rope_dim) with interleaved pairs -> roped, half-split."""
    b, t, h, d = x.shape
    x = x.view(b, t, h, d // 2, 2).transpose(3, 4).reshape(b, t, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return (x.float() * cos[:, :, None] + rot.float() * sin[:, :, None]).to(x.dtype)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

def _span(name: str):
    """A profiling span, but none inside a CUDA graph capture."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return contextlib.nullcontext()
    return profiling.span(name)


def _swiglu(p, x, dtype):
    return L.linear(p["down"], F.silu(L.linear(p["gate"], x, dtype))
                    * L.linear(p["up"], x, dtype), dtype)


def _write(slab: torch.Tensor, pos, rows: torch.Tensor) -> None:
    """slab (L, B, ...) takes rows (B, T, ...) at columns [pos, pos + T), or
    at the one column in `pos`, a one-element int64 tensor on the device."""
    if torch.is_tensor(pos):
        slab.index_copy_(0, pos, rows.transpose(0, 1).to(slab.dtype))
    else:
        slab[pos:pos + rows.shape[1]] = rows.transpose(0, 1).to(slab.dtype)


def _project(lp, h, cos, sin, cfg, dtype):
    """The layer's normed input -> q_nope (B, T, H, nope), roped q_pe
    (B, T, H, rope) and the new cache rows (B, T, latent_dim). cos None:
    no rotation (NoPE), the rope dims kept as projected."""
    hin = L.rms_norm(lp["ln1"], h, cfg.rms_norm_eps)
    q = L.linear(lp["q"], hin, dtype).unflatten(-1, (cfg.num_heads, cfg.q_head_dim))
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], dim=-1)
    kva = L.linear(lp["kv_a"], hin, dtype)
    c = L.rms_norm(lp["kv_norm"], kva[..., :cfg.kv_lora_rank], cfg.rms_norm_eps)
    if cos is None:
        return q_nope, q_pe, torch.cat([c, kva[..., cfg.kv_lora_rank:]], dim=-1)
    k_pe = apply_rope(kva[..., None, cfg.kv_lora_rank:], cos, sin)[:, :, 0]
    return q_nope, apply_rope(q_pe, cos, sin), torch.cat([c, k_pe], dim=-1)


def _attend_full(lp, q_nope, q_pe, rows, mask4, cfg, dtype):
    """The published, non-absorbed form over cache rows (B, Lk, latent):
    k = [W_uk c; k_pe], v = W_uv c; logits and softmax in fp32."""
    h, nope = cfg.num_heads, cfg.qk_nope_head_dim
    kv = L.linear(lp["kv_b"], rows[..., :cfg.kv_lora_rank].to(dtype), dtype)
    kv = kv.unflatten(-1, (h, nope + cfg.v_head_dim))
    k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
    k_pe = rows[..., None, cfg.kv_lora_rank:].to(dtype).expand(-1, -1, h, -1)
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe], dim=-1)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * cfg.softmax_scale
    if mask4 is not None:
        logits = logits.masked_fill(~mask4, -1e10)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(dtype), v)


def _attend_absorbed(lp, q_nope, q_pe, slab, valid, cfg, dtype):
    """One token a row, absorbed: q_nope (B, H, nope) through W_uk to the
    latent width, scored with q_pe against the cache slab (Lc, B, latent),
    keys where `valid` (B, Lc); the probabilities weigh the latents, and
    W_uv maps each head's result to its v. Returns (B, H, v_head_dim)."""
    h, nope, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.kv_lora_rank
    w_kvb = L._cast(lp["kv_b"]["w"], dtype).view(r, h, nope + cfg.v_head_dim)
    q_abs = torch.einsum("bhn,rhn->bhr", q_nope, w_kvb[..., :nope])
    q = torch.cat([q_abs, q_pe.to(dtype)], dim=-1)                 # (B, H, latent)
    keys = slab.permute(1, 2, 0)                                    # (B, latent, Lc)
    logits = torch.matmul(q, keys.to(dtype)).float() * cfg.softmax_scale
    logits = logits.masked_fill(~valid[:, None, :], -1e10)
    w = torch.softmax(logits, dim=-1).to(dtype)
    lat = torch.matmul(w, keys[:, :r].transpose(1, 2).to(dtype))   # (B, H, r)
    return torch.einsum("bhr,rhv->bhv", lat, w_kvb[..., nope:])


def route(lp, x: torch.Tensor, cfg):
    """x (N, D) -> (expert ids (N, k) int64, weights (N, k) fp32) over all
    the routed experts, held or not. Softmax scoring: the fp32 softmax, its
    greedy top-k (sorted), weights not renormalised, times
    routed_scaling_factor. Sigmoid scoring (Kimi-Linear's KimiMoEGate):
    fp32 sigmoid scores s, the top-k of s + the router's
    e_score_correction_bias (one group), the chosen s without the bias
    renormalised to sum 1, times routed_scaling_factor."""
    logits = x.float() @ lp["router"]["w"].float()
    if cfg.scoring_func == "sigmoid":
        s = torch.sigmoid(logits)
        ids = torch.topk(s + lp["router"]["e_score_correction_bias"].float(),
                         cfg.num_experts_per_tok, dim=-1).indices
        return ids, _renormalised(s.gather(1, ids), cfg)
    w, ids = torch.topk(torch.softmax(logits, dim=-1), cfg.num_experts_per_tok, dim=-1)
    return ids, w * cfg.routed_scaling_factor


def _renormalised(w: torch.Tensor, cfg) -> torch.Tensor:
    return w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor


def _forced_weights(lp, x: torch.Tensor, cfg, ids: torch.Tensor) -> torch.Tensor:
    """The router's fp32 weights of the forced expert ids (N, k), as `route`
    weighs its own choice."""
    logits = x.float() @ lp["router"]["w"].float()
    if cfg.scoring_func == "sigmoid":
        return _renormalised(torch.sigmoid(logits).gather(1, ids), cfg)
    return torch.softmax(logits, dim=-1).gather(1, ids) * cfg.routed_scaling_factor


def held_range(cfg) -> Tuple[int, int]:
    """The routed experts [lo, hi) that the layer holds."""
    return cfg.experts_held or (0, cfg.n_routed_experts)


def sort_by_expert(ids: torch.Tensor, n_experts: int):
    """Assignments (N, k) -> (order (N*k,): the assignments in expert order,
    stable; dest (N*k,): each assignment's place in that order; offsets
    (E + 1,) int32; counts (E,)). All on the device and of fixed shape: no
    host read, so a graph can hold it."""
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    dest = torch.empty_like(order).index_copy_(0, order, torch.arange(
        order.numel(), device=flat.device))
    counts = torch.zeros(n_experts, dtype=torch.int64, device=flat.device).index_add_(
        0, flat, torch.ones_like(flat))
    offsets = torch.cat([torch.zeros_like(counts[:1]), counts.cumsum(0)]).to(torch.int32)
    return order, dest, offsets, counts


def _count(tally: list) -> None:
    """The device counters of a forward's MoE calls (utils/profiling.py),
    from their held experts' counts (E held,) in `tally`: added once a
    forward, so that a graphed step holds a handful of kernels for them,
    not a handful a layer."""
    if not tally:
        return
    c = torch.stack(tally)                                          # (calls, E held)
    profiling.device_add("moe.calls", torch.full_like(c[0, 0], len(tally)))
    profiling.device_add("moe.assignments", c.sum())
    profiling.device_add("moe.experts_touched", (c > 0).sum())
    profiling.device_add("moe.max_expert_rows", c.amax(dim=1).sum())


def moe(lp, x: torch.Tensor, cfg, dtype, ids=None, tally=None):
    """The MoE feed-forward of x (N, D): the held routed experts through K7,
    weighted by the router's fp32 weights and summed in fp32, plus the
    shared experts. Returns (y (N, D), ids (N, k)). `ids` forces the routing
    (the weights are then the router's scores of those ids); `tally`, a
    list, takes the call's held expert counts (E held,) for the device
    counters. An assignment to an expert the layer does not hold
    (`experts_held`) is sorted past the held ones, K7 never reads it, and
    its part is left out of the sum."""
    n, k = x.shape[0], cfg.num_experts_per_tok
    lo, hi = held_range(cfg)
    whole = (lo, hi) == (0, cfg.n_routed_experts)
    with _span("dsv2.route"):
        if ids is None:
            ids, w = route(lp, x, cfg)
        else:
            w = _forced_weights(lp, x, cfg, ids)
        if whole:
            local = ids
            order, dest, offsets, counts = sort_by_expert(ids, hi - lo)
        else:
            # an absent expert's assignments go to one more bucket, past the held
            local = torch.where((ids >= lo) & (ids < hi), ids - lo, hi - lo)
            order, dest, offsets, counts = sort_by_expert(local, hi - lo + 1)
            offsets, counts = offsets[:hi - lo + 1], counts[:hi - lo]
        xs = x[torch.div(order, k, rounding_mode="floor")].to(dtype).contiguous()
        if tally is not None:
            tally.append(counts)
    with _span("dsv2.experts"):
        ex = lp["experts"]
        ys = moe_experts.grouped_swiglu(xs, offsets, ex["gate"]["w"], ex["up"]["w"],
                                        ex["down"]["w"])
        ys = ys[dest].view(n, k, -1)
        if not whole:
            ys = torch.where((local < hi - lo)[..., None], ys, torch.zeros_like(ys[:1, :1]))
        y = (ys * w[..., None]).sum(1).to(dtype)
    return y + _swiglu(lp["shared"], x, dtype), ids


def _ffn(lp, i: int, h, cfg: DeepseekV2Config, dtype, cache, pos, tally):
    """The layer's second half, residual included; an MoE layer writes its
    ids into the cache's routing record at the block's columns, and its
    expert counts into `tally` (a list, or None)."""
    hin = L.rms_norm(lp["ln2"], h, cfg.rms_norm_eps)
    if i < cfg.first_k_dense_replace:
        return h + _swiglu(lp["mlp"], hin, dtype)
    b, t, d = hin.shape
    j = i - cfg.first_k_dense_replace
    y, ids = moe(lp, hin.reshape(b * t, d), cfg, dtype, tally=tally)
    if cache is not None and cache.route is not None:
        _write(cache.route[j], pos, ids.view(b, t, -1))
    return h + y.view(b, t, d)


def decode_valid(lc: int, b: int, cache_pos, start=0, hole=None, span=None, device=None):
    """(B, Lc) bool: the keys a single-token step attends: [start, cache_pos]
    (or each row's [span0, span1]) minus each row's hole [lo, hi); a row
    left with no key keeps key 0, so that its softmax stays finite (its
    output is never used)."""
    k = torch.arange(lc, device=device)[None]
    if span is not None:
        span = span.to(device).long()
        valid = (k >= span[:, :1]) & (k <= span[:, 1:])
    else:
        start = start.to(device).long().reshape(1, 1) if torch.is_tensor(start) else start
        valid = ((k >= start) & (k <= cache_pos)).expand(b, lc)
    if hole is not None:
        hole = hole.to(device).long()
        valid = valid & ~((k >= hole[:, :1]) & (k < hole[:, 1:]))
    return valid | ((k == 0) & ~valid.any(dim=1, keepdim=True))


def forward(params, x: torch.Tensor, pos_ids: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None, cache: Optional[LatentCache] = None,
            cache_pos=0, cfg: DeepseekV2Config = DeepseekV2Config(), dtype=torch.float32,
            flash_start=0, flash_hole=None, collect_attn_layer=None, flash_span=None,
            remat: bool = False, mesh=None, key_valid=None):
    """The backbone over a block of embeddings, as llama.forward, whose
    arguments it takes; the alignment row (`collect_attn_layer`), `remat`
    and a mesh are not run here (backbone.check refuses them upstream) and
    raise.

    x (B, T, D), pos_ids (B, T). attn_mask (B|1, T, L) bool for a block
    (default causal); a single-token step with a cache attends [flash_start,
    cache_pos] or each row's `flash_span`, minus `flash_hole`, or the keys
    of `key_valid` (B, Lc) when given. cache_pos is an int, or for a single
    token a one-element int64 tensor on the device (the column the step
    writes). The block's rows (and routing ids) are written at [cache_pos,
    cache_pos + T) before it attends. Returns (hidden after the final norm,
    cache)."""
    if collect_attn_layer is not None or remat or mesh is not None:
        raise ValueError("deepseek_v2.forward: no alignment row, remat or mesh")
    b, t, _ = x.shape
    h = x.to(dtype)
    cos, sin = rope_cos_sin(pos_ids, cfg)
    decode = t == 1 and cache is not None
    if decode:
        lc = cache.c.shape[1]
        valid = key_valid if key_valid is not None else decode_valid(
            lc, b, cache_pos, flash_start, flash_hole, flash_span, x.device)
    elif attn_mask is None:
        if cache is None:
            attn_mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()[None]
        else:
            idx = torch.arange(cache.c.shape[1], device=x.device)[None, :]
            attn_mask = (idx <= cache_pos + torch.arange(t, device=x.device)[:, None])[None]
    mask4 = None if decode else attn_mask[:, None]
    tally = [] if profiling.device_counting() else None
    for i, lp in enumerate(params["layers"]):
        with _span("dsv2.attention"):
            q_nope, q_pe, rows = _project(lp, h, cos, sin, cfg, dtype)
            if cache is None:
                att = _attend_full(lp, q_nope, q_pe, rows, mask4, cfg, dtype)
            else:
                _write(cache.c[i], cache_pos, rows)
                if decode:
                    att = _attend_absorbed(lp, q_nope[:, 0], q_pe[:, 0], cache.c[i], valid,
                                           cfg, dtype)[:, None]
                else:
                    att = _attend_full(lp, q_nope, q_pe, cache.c[i].transpose(0, 1), mask4,
                                       cfg, dtype)
            h = h + L.linear(lp["o"], att.flatten(-2), dtype)
        h = _ffn(lp, i, h, cfg, dtype, cache, cache_pos, tally)
    if tally is not None:
        _count(tally)
    return L.rms_norm(params["norm"], h, cfg.rms_norm_eps), cache
