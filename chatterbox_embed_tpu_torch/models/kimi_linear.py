"""Kimi-Linear as T3's backbone: Kimi Delta Attention (KDA) layers beside
NoPE latent attention (MLA), and sigmoid-routed experts, after the
published modeling code (moonshotai/Kimi-Linear-48B-A3B-Instruct,
`modeling_kimi.py`; fla's `KimiDeltaAttention`; arXiv:2510.26692). T3 wraps
it as it wraps Llama_520M and DeepSeek-V2: its own conditioning, tables,
positions and speech head; the backbone's token table and head are not
held.

- Layer kinds come from `linear_attn_config` (1-indexed `kda_layers` and
  `full_attn_layers`), not from a period. Pre-norm RMSNorm (eps 1e-5);
  each layer's second half is a dense SwiGLU for the first
  `first_k_dense_replace` layers, then MoE.
- A KDA layer, per token t and head h (dk = dv = 128): q, k, v = W_q x,
  W_k x, W_v x, each through a causal depthwise conv of 4 taps (no bias)
  and SiLU; q and k L2-normalised per head, q scaled by dk^-1/2; beta_t =
  sigmoid(W_b x) a head; g_t = -exp(A_log_h) * softplus(W_fb W_fa x +
  dt_bias) a key channel (fla's fused_kda_gate); the gated delta rule on
  the fp32 state S (dk x dv) through K9 (`kernels/kda.py`): S' =
  Diag(exp(g_t)) S, S = S' + beta_t k_t (v_t - S'^T k_t)^T, o_t = S^T
  q_t; then o's per-head RMSNorm times sigmoid(W_gb W_ga x) (fla's
  FusedRMSNormGated) and W_o. The conv and its window, the low-rank
  products and the norm are torch ops.
- An MLA layer is DeepSeek-V2's (models/deepseek_v2.py: the projection,
  the non-absorbed block form, the absorbed single-token form, the latent
  cache rows) with `mla_use_nope`: no rotation, the 64 "rope" dims of q
  and of the shared k_pe kept and cached as projected; softmax scale
  192^-1/2 (no YaRN mscale: rope_scaling is null).
- An MoE layer is DeepSeek-V2's `moe` with sigmoid scoring: fp32 sigmoid
  scores over all the routed experts, the top k of score +
  e_score_correction_bias, the chosen scores renormalised, x
  routed_scaling_factor; one shared SwiGLU. The layer holds the experts of
  `experts_held` (one card's share of an expert-parallel deployment):
  only their assignments reach K7, and what the absent experts would add
  is left out.
- The cache (`HybridCache`) is three kinds of state: the MLA layers'
  latent rows (mla layers, L, B, 576) in the engine's sequence-major
  layout, and the routing record, as DeepSeek-V2's `LatentCache`; and per
  row, fixed in size, each KDA layer's fp32 state (kda layers, B, H, dk,
  dv) and its conv window, the last conv_size - 1 inputs of q, k and v
  (kda layers, B, conv_size - 1, 3 H dk) in the compute dtype. A block
  whose cache_pos is 0 (a prefill) starts both from zero and overwrites
  them; a later block or a single-token step continues them. No mask
  guards the state, so positions that no key mask lets a row see (its
  left pad: the diagonal of `attn_mask`) enter neither: their conv inputs
  are zeroed, and K9 passes them over (beta 0, decay 1, and the row's
  count of leading positions skipped). A hole after a valid position
  (ragged rows of one lock-step batch) cannot be cut from a recurrence and
  raises.
- Device counters (utils/profiling.py), added on the card once a forward:
  `kda.calls`, `kda.tokens` (row-tokens through K9), `kda.states_read` and
  `kda.states_written` ((row, head) states); the MoE layers' `moe.*` over
  the held experts. Span `kimi.kda` wraps the eager KDA layers; none opens
  while a CUDA graph is being captured.

What T3 does not run on this backbone (`UNSUPPORTED`: DeepSeek-V2's set)
raises where it is asked for (`backbone.check`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels import kda
from ..utils import profiling
from . import deepseek_v2 as dsv2
from . import layers as L

# T3's face of a backbone (models/backbone.py)
NAME = "Kimi-Linear"
UNSUPPORTED = dsv2.UNSUPPORTED
WHOLE_STEP = True
SERVING_KERNELS = ("moe_experts", "kda_recurrent")

_MLA = (4, 8, 12, 16, 20, 24, 27)


@dataclass(frozen=True)
class KimiLinearConfig:
    """Kimi-Linear-48B-A3B's backbone (config.json of moonshotai/Kimi-Linear-
    48B-A3B-Instruct), without its 163,840-row token table and head; every
    routed expert held unless `experts_held` says otherwise."""
    hidden_size: int = 2304
    num_layers: int = 27
    kda_layers: Tuple[int, ...] = tuple(i for i in range(1, 27) if i % 4)   # 1-indexed
    full_attn_layers: Tuple[int, ...] = _MLA
    kda_heads: int = 32
    kda_head_dim: int = 128
    conv_size: int = 4
    num_heads: int = 32                       # MLA's
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    n_routed_experts: int = 256
    n_shared_experts: int = 1
    num_experts_per_tok: int = 8
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    scoring_func: str = "sigmoid"
    experts_held: Optional[Tuple[int, int]] = None      # [lo, hi); None: every expert

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        return self.q_head_dim ** -0.5

    @property
    def moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @property
    def kinds(self) -> Tuple[str, ...]:
        """Each layer's attention, 0-indexed: "kda" or "mla"."""
        return tuple("kda" if i + 1 in self.kda_layers else "mla" for i in range(self.num_layers))

    @property
    def conv_dim(self) -> int:
        """A conv window row: q, k and v of every head."""
        return 3 * self.kda_heads * self.kda_head_dim


# the published config.json's settings that this module computes as given
_FIXED = {"q_lora_rank": None, "mla_use_nope": True, "moe_router_activation_func": "sigmoid",
          "moe_renormalize": True, "num_expert_group": 1, "topk_group": 1, "moe_layer_freq": 1,
          "rope_scaling": None, "hidden_act": "silu", "num_nextn_predict_layers": 0}


def from_hf_config(c: dict) -> KimiLinearConfig:
    """The backbone of a published Kimi-Linear config.json (a dict); a
    setting this module does not compute raises. `num_experts` is how many
    routed experts are held (experts 0 .. num_experts - 1), of
    `published_num_experts` (default: num_experts), which the router
    scores."""
    for k, want in _FIXED.items():
        if c.get(k, want) != want:
            raise ValueError(f"Kimi-Linear config: {k}={c[k]!r} is not ported (want {want!r})")
    la = c["linear_attn_config"]
    n = c["num_hidden_layers"]
    kda_l, mla_l = tuple(la["kda_layers"]), tuple(la["full_attn_layers"])
    if sorted(kda_l + mla_l) != list(range(1, n + 1)):
        raise ValueError("Kimi-Linear config: kda_layers and full_attn_layers must share out "
                         f"layers 1..{n}")
    routed = c.get("published_num_experts", c["num_experts"])
    held = c["num_experts"]
    return KimiLinearConfig(
        hidden_size=c["hidden_size"], num_layers=n, kda_layers=kda_l, full_attn_layers=mla_l,
        kda_heads=la["num_heads"], kda_head_dim=la["head_dim"],
        conv_size=la["short_conv_kernel_size"], num_heads=c["num_attention_heads"],
        kv_lora_rank=c["kv_lora_rank"], qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        intermediate_size=c["intermediate_size"],
        moe_intermediate_size=c["moe_intermediate_size"], n_routed_experts=routed,
        n_shared_experts=c["num_shared_experts"], num_experts_per_tok=c["num_experts_per_token"],
        first_k_dense_replace=c["first_k_dense_replace"],
        routed_scaling_factor=float(c["routed_scaling_factor"]),
        rms_norm_eps=float(c["rms_norm_eps"]),
        experts_held=None if held == routed else (0, held))


class HybridCache(NamedTuple):
    """The latent rows (mla layers, L, B, latent_dim) and the routing record
    (moe layers, L, B, top_k) int16 or None, sequence-major as DeepSeek-V2's
    LatentCache; each KDA layer's fp32 state (kda layers, B, H, dk, dv) and
    conv window (kda layers, B, conv_size - 1, conv_dim), a row's whatever
    its length (`ROW_STATE`: the fields a slot insert copies whole)."""
    c: torch.Tensor
    route: Optional[torch.Tensor]
    kda: torch.Tensor
    conv: torch.Tensor

    ROW_STATE = ("kda", "conv")


def kv_heads(params, cfg: KimiLinearConfig) -> int:
    """One latent row a token, shared by every head."""
    return 1


def init_cache(cfg: KimiLinearConfig, batch: int, max_len: int, dtype=torch.float32,
               device=None, heads: Optional[int] = None, route: bool = False) -> HybridCache:
    """Zero latent rows (in `dtype`), states (fp32) and windows (in `dtype`);
    with `route` the zero routing record. `heads` is not read."""
    device = resolve_device(device)
    kinds = cfg.kinds
    n_mla, n_kda = kinds.count("mla"), kinds.count("kda")
    h, dk = cfg.kda_heads, cfg.kda_head_dim
    rec = None
    if route:
        rec = torch.zeros((cfg.moe_layers, max_len, batch, cfg.num_experts_per_tok),
                          dtype=torch.int16, device=device)
    return HybridCache(
        c=torch.zeros((n_mla, max_len, batch, cfg.latent_dim), dtype=dtype, device=device),
        route=rec,
        kda=torch.zeros((n_kda, batch, h, dk, dk), dtype=torch.float32, device=device),
        conv=torch.zeros((n_kda, batch, cfg.conv_size - 1, cfg.conv_dim), dtype=dtype,
                         device=device))


def cache_bytes_per_token(cfg: KimiLinearConfig, dtype=torch.bfloat16,
                          int8: bool = False) -> int:
    """The MLA layers' latent row a token (the KDA states are a row's,
    whatever its length; no int8 cache: backbone.check refuses it)."""
    n_mla = cfg.kinds.count("mla")
    return n_mla * cfg.latent_dim * torch.empty((), dtype=dtype).element_size()


def _kda_init(init: L.Init, cfg: KimiLinearConfig):
    """A KDA layer's params, as fla's KimiDeltaAttention draws them: A_log
    = log(U(1, 16)) a head; dt_bias the inverse softplus of dt, log-uniform
    in [0.001, 0.1] (floor 1e-4) a key channel; the conv's taps at
    PyTorch's Conv1d spread (fan-in 4); the rest as linears."""
    d, h, dk = cfg.hidden_size, cfg.kda_heads, cfg.kda_head_dim
    width = h * dk
    a = init.uniform((h,), 7.5) + 8.5
    dt = torch.exp(init.uniform((width,), 0.5 * math.log(100.0))
                   + 0.5 * (math.log(0.001) + math.log(0.1))).clamp_min(1e-4)
    return {
        "q": L.linear_init(init, d, width, bias=False),
        "k": L.linear_init(init, d, width, bias=False),
        "v": L.linear_init(init, d, width, bias=False),
        "conv": {"w": init.uniform((cfg.conv_size, cfg.conv_dim), 1.0 / math.sqrt(cfg.conv_size))},
        "A_log": torch.log(a),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "f_a": L.linear_init(init, d, dk, bias=False),
        "f_b": L.linear_init(init, dk, width, bias=False),
        "b": L.linear_init(init, d, h, bias=False),
        "g_a": L.linear_init(init, d, dk, bias=False),
        "g_b": L.linear_init(init, dk, width, bias=False),
        "o_norm": {"scale": init.ones((dk,))},
        "o": L.linear_init(init, width, d, bias=False),
    }


def init(init: L.Init, cfg: KimiLinearConfig = KimiLinearConfig()):
    d, h = cfg.hidden_size, cfg.num_heads
    lo, hi = dsv2.held_range(cfg)
    e, f = hi - lo, cfg.moe_intermediate_size
    layers = []
    for i, kind in enumerate(cfg.kinds):
        lp = {"ln1": {"scale": init.ones((d,))}, "ln2": {"scale": init.ones((d,))}}
        if kind == "kda":
            lp["kda"] = _kda_init(init, cfg)
        else:
            lp.update({
                "q": L.linear_init(init, d, h * cfg.q_head_dim, bias=False),
                "kv_a": L.linear_init(init, d, cfg.latent_dim, bias=False),
                "kv_norm": {"scale": init.ones((cfg.kv_lora_rank,))},
                "kv_b": L.linear_init(init, cfg.kv_lora_rank,
                                      h * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False),
                "o": L.linear_init(init, h * cfg.v_head_dim, d, bias=False)})
        if i < cfg.first_k_dense_replace:
            lp["mlp"] = dsv2._swiglu_init(init, d, cfg.intermediate_size)
        else:
            lp["router"] = dict(L.linear_init(init, d, cfg.n_routed_experts, bias=False),
                                e_score_correction_bias=init.uniform((cfg.n_routed_experts,),
                                                                     0.05))
            lp["experts"] = {
                "gate": {"w": init.uniform((e, d, f), math.sqrt(3.0 / d))},
                "up": {"w": init.uniform((e, d, f), math.sqrt(3.0 / d))},
                "down": {"w": init.uniform((e, f, d), math.sqrt(3.0 / f))}}
            lp["shared"] = dsv2._swiglu_init(init, d, f * cfg.n_shared_experts)
        layers.append(lp)
    return {"layers": layers, "norm": {"scale": init.ones((d,))}}


# ---------------------------------------------------------------------------
# the KDA layer
# ---------------------------------------------------------------------------

def _l2norm(x: torch.Tensor) -> torch.Tensor:
    """fla's l2norm: x / sqrt(sum x^2 + 1e-6), in fp32."""
    return x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-6)


def _count(n_layers: int, rows: int, tokens: torch.Tensor, heads: int, read: bool) -> None:
    """The forward's K9 counters, once for its n_layers calls of `rows`
    rows: `tokens` (a 0-dim device tensor) row-tokens a call."""
    if not n_layers or not profiling.device_counting():
        return
    one = torch.ones((), dtype=torch.int64, device=tokens.device)
    profiling.device_add("kda.calls", one * n_layers)
    profiling.device_add("kda.tokens", tokens.long() * n_layers)
    profiling.device_add("kda.states_read", one * (n_layers * rows * heads if read else 0))
    profiling.device_add("kda.states_written", one * (n_layers * rows * heads))


def kda_layer(p, hin: torch.Tensor, cfg: KimiLinearConfig, dtype, state: torch.Tensor,
              window: Optional[torch.Tensor], fresh: bool, valid=None, skip=None):
    """One KDA layer's attention on its normed input hin (B, T, D): returns
    its output (B, T, D) in `dtype`; `state` (B, H, dk, dv) fp32 is read
    (unless `fresh`) and written in place, `window` (B, K - 1, conv_dim),
    the conv's last inputs, likewise (None: no cache, zeros before the
    block). valid (B|1, T) bool: the positions the row sees (None: all);
    skip (B,) int32: its leading positions not seen."""
    b, t, _ = hin.shape
    h, dk, kk = cfg.kda_heads, cfg.kda_head_dim, cfg.conv_size
    x = torch.cat([L.linear(p["q"], hin, dtype), L.linear(p["k"], hin, dtype),
                   L.linear(p["v"], hin, dtype)], dim=-1)
    if valid is not None:
        x = x * valid[..., None].to(x.dtype)
    if fresh or window is None:
        prev = torch.zeros((b, kk - 1, x.shape[-1]), dtype=x.dtype, device=x.device)
    else:
        prev = window.to(x.dtype)
    seq = torch.cat([prev, x], dim=1)                              # (B, K - 1 + T, C)
    if window is not None:
        window.copy_(seq[:, t:])
    w = p["conv"]["w"].float()                                     # (K, C)
    y = seq[:, :t].float() * w[0]
    for j in range(1, kk):
        y = y + seq[:, j:j + t].float() * w[j]
    q, k, v = F.silu(y).unflatten(-1, (3 * h, dk)).split(h, dim=2)
    q = _l2norm(q) * dk ** -0.5
    k = _l2norm(k)
    beta = torch.sigmoid(L.linear(p["b"], hin, dtype).float())     # (B, T, H)
    f = L.linear(p["f_b"], L.linear(p["f_a"], hin, dtype), dtype).float()
    g = -torch.exp(p["A_log"].float())[:, None] * F.softplus(
        f.unflatten(-1, (h, dk)) + p["dt_bias"].float().view(h, dk))
    if valid is not None:
        on = valid.to(torch.float32)
        beta = beta * on[..., None]
        g = g * on[..., None, None]
    o = kda.kda_recurrent(q.contiguous(), k.contiguous(), v.contiguous(), g.contiguous(),
                          beta.contiguous(), state, skip, read_state=not fresh)
    gate = L.linear(p["g_b"], L.linear(p["g_a"], hin, dtype), dtype).float()
    o = o * torch.rsqrt(o.square().mean(-1, keepdim=True) + cfg.rms_norm_eps)
    o = o * p["o_norm"]["scale"].float() * torch.sigmoid(gate.unflatten(-1, (h, dk)))
    return L.linear(p["o"], o.flatten(-2).to(dtype), dtype)


def _seen(attn_mask: torch.Tensor, cache_pos: int, t: int):
    """(valid (B|1, T) bool, skip (B,) or None): each position's own key in
    the block's mask; a position after a seen one that is not seen raises
    (read on the host only for a per-row mask, which the engine never
    passes)."""
    valid = attn_mask.diagonal(offset=cache_pos, dim1=1, dim2=2)[:, :t]
    lead = torch.cumprod((~valid).to(torch.int32), dim=1)
    if valid.shape[0] > 1 and bool(((~valid).sum(1) != lead.sum(1)).any()):
        raise ValueError("Kimi-Linear: a hole after a seen position (ragged rows) cannot be "
                         "cut from the KDA recurrence")
    return valid, lead.sum(1).to(torch.int32)


# ---------------------------------------------------------------------------
# the backbone
# ---------------------------------------------------------------------------

def forward(params, x: torch.Tensor, pos_ids: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None, cache: Optional[HybridCache] = None,
            cache_pos=0, cfg: KimiLinearConfig = KimiLinearConfig(), dtype=torch.float32,
            flash_start=0, flash_hole=None, collect_attn_layer=None, flash_span=None,
            remat: bool = False, mesh=None, key_valid=None):
    """The backbone over a block of embeddings, as deepseek_v2.forward, whose
    arguments it takes (pos_ids are not read: no layer rotates).

    x (B, T, D). attn_mask (B|1, T, L) bool for a block (default causal);
    a single-token step with a cache attends its MLA layers' keys as
    DeepSeek-V2's step does (`key_valid`, or the span, hole and start), and
    continues each KDA layer's state and window; a row whose own key at
    cache_pos is hidden (a finished slot, t3_engine.latent_keys) feeds no
    state, so that its states stay as it finished. A block at cache_pos 0
    starts the KDA states from zero and overwrites them; its positions
    that the mask hides from themselves (the left pad) enter no state.
    Returns (hidden after the final norm, cache)."""
    if collect_attn_layer is not None or remat or mesh is not None:
        raise ValueError("kimi_linear.forward: no alignment row, remat or mesh")
    b, t, _ = x.shape
    h = x.to(dtype)
    decode = t == 1 and cache is not None
    valid = skip = None
    if decode:
        lc = cache.c.shape[1]
        keys = key_valid if key_valid is not None else dsv2.decode_valid(
            lc, b, cache_pos, flash_start, flash_hole, flash_span, x.device)
        fresh = False
        col = torch.as_tensor(cache_pos, device=x.device).long().reshape(1, 1).expand(b, 1)
        skip = (~keys.gather(1, col)[:, 0]).to(torch.int32)
    else:
        if attn_mask is None:
            if cache is None:
                attn_mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()[None]
            else:
                idx = torch.arange(cache.c.shape[1], device=x.device)[None, :]
                attn_mask = (idx <= cache_pos + torch.arange(t, device=x.device)[:, None])[None]
        fresh = cache is None or cache_pos == 0
        valid, skip = _seen(attn_mask, 0 if cache is None else cache_pos, t)
        skip = skip.expand(b).contiguous()
    mask4 = None if decode else attn_mask[:, None]
    tally = [] if profiling.device_counting() else None
    n_kda = 0
    states = cache.kda if cache is not None else torch.empty(
        (cfg.kinds.count("kda"), b, cfg.kda_heads, cfg.kda_head_dim, cfg.kda_head_dim),
        dtype=torch.float32, device=x.device)
    i_mla = 0
    for i, lp in enumerate(params["layers"]):
        if cfg.kinds[i] == "kda":
            with dsv2._span("kimi.kda"):
                hin = L.rms_norm(lp["ln1"], h, cfg.rms_norm_eps)
                h = h + kda_layer(lp["kda"], hin, cfg, dtype, states[n_kda],
                                  None if cache is None else cache.conv[n_kda], fresh, valid,
                                  skip)
            n_kda += 1
        else:
            with dsv2._span("dsv2.attention"):
                q_nope, q_pe, rows = dsv2._project(lp, h, None, None, cfg, dtype)
                if cache is None:
                    att = dsv2._attend_full(lp, q_nope, q_pe, rows, mask4, cfg, dtype)
                else:
                    dsv2._write(cache.c[i_mla], cache_pos, rows)
                    if decode:
                        att = dsv2._attend_absorbed(lp, q_nope[:, 0], q_pe[:, 0], cache.c[i_mla],
                                                    keys, cfg, dtype)[:, None]
                    else:
                        att = dsv2._attend_full(lp, q_nope, q_pe, cache.c[i_mla].transpose(0, 1),
                                                mask4, cfg, dtype)
                h = h + L.linear(lp["o"], att.flatten(-2), dtype)
            i_mla += 1
        h = dsv2._ffn(lp, i, h, cfg, dtype, cache, cache_pos, tally)
    if tally is not None:
        dsv2._count(tally)
        tokens = (torch.full((), b * t, device=x.device) if skip is None
                  else t * b - skip.sum())
        _count(n_kda, b, tokens, cfg.kda_heads, not fresh)
    return L.rms_norm(params["norm"], h, cfg.rms_norm_eps), cache
