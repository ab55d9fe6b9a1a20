"""A plain fp32 DeepSeek-V2 backbone, the tests' reference for
`chatterbox_embed_tpu_torch/models/deepseek_v2.py`.

It follows the published modeling code (deepseek-ai/DeepSeek-V2-Lite,
`modeling_deepseek.py`) and reads the published config.json's keys: no
q-LoRA; multi-head latent attention in its non-absorbed form (k = [W_uk
norm(c); k_pe], v = W_uv norm(c)); YaRN RoPE with its mscale, on rope dims
read as interleaved pairs; a dense SwiGLU for the first
`first_k_dense_replace` layers, then the fp32 softmax router, its greedy
top-k with weights not renormalised, a loop over the chosen experts and the
shared experts. Matrix products in fp32 with TF32 off, no cache, no
batching tricks, no kernels. It imports nothing of the port and no JAX.

Departures, none of which changes a value beyond the order of a sum: the
top-k is taken sorted (the published gate asks for it unsorted); the
router's choice may be forced (`forced`), the weights then being the
router's own scores of the forced experts, which is what the checks need.

Parameters are the port's tree: a linear {"w": (in, out)}, the routed
experts stacked (E, in, out).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def exact_fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_inv_freq(c: dict) -> torch.Tensor:
    """DeepseekV2YarnRotaryEmbedding's inv_freq, in torch fp32 as published."""
    rs, dim, base = c["rope_scaling"], c["qk_rope_head_dim"], c["rope_theta"]
    pw = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    extra = 1.0 / pw
    inter = 1.0 / (rs["factor"] * pw)
    low = max(math.floor(_correction_dim(rs["beta_fast"], dim, base,
                                         rs["original_max_position_embeddings"])), 0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], dim, base,
                                         rs["original_max_position_embeddings"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(c: dict) -> float:
    rs = c["rope_scaling"]
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    return scale * m * m


def _rope(x, pos, c):
    """x (B, T, H, d) interleaved pairs -> de-interleaved, rotated half."""
    rs = c["rope_scaling"]
    inv = yarn_inv_freq(c).to(x.device)
    freqs = torch.outer(pos.float(), inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    cos, sin = (emb.cos() * m)[None, :, None], (emb.sin() * m)[None, :, None]
    b, t, h, d = x.shape
    x = x.view(b, t, h, d // 2, 2).transpose(4, 3).reshape(b, t, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def rms_norm(p, x, eps):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * p["scale"].float()


def linear(p, x):
    return x.float() @ p["w"].float()


def swiglu(p, x):
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


def attention(lp, x, mask, c):
    """x (B, T, D) normed, mask (B|1, T, T) bool: the non-absorbed MLA."""
    b, t, _ = x.shape
    h, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                         c["v_head_dim"])
    r = c["kv_lora_rank"]
    pos = torch.arange(t, device=x.device)
    q = linear(lp["q"], x).view(b, t, h, nope + rope)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    kva = linear(lp["kv_a"], x)
    latent, k_pe = kva.split([r, rope], dim=-1)
    kv = linear(lp["kv_b"], rms_norm(lp["kv_norm"], latent, c["rms_norm_eps"]))
    k_nope, v = kv.view(b, t, h, nope + vd).split([nope, vd], dim=-1)
    q_pe = _rope(q_pe, pos, c)
    k_pe = _rope(k_pe.view(b, t, 1, rope), pos, c)
    qs = torch.cat([q_nope, q_pe], dim=-1)
    ks = torch.cat([k_nope, k_pe.expand(b, t, h, rope)], dim=-1)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, ks) * softmax_scale(c)
    s = s.masked_fill(~mask[:, None], float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return linear(lp["o"], o.reshape(b, t, h * vd))


def moe(lp, x, c, forced=None):
    """x (N, D) normed -> (y (N, D), ids (N, k), router probabilities (N, E)).
    forced (N, k): the experts to take instead of the router's top-k."""
    exact_fp32()
    probs = torch.softmax(linear(lp["router"], x), dim=-1)
    if forced is None:
        w, ids = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
    else:
        ids = forced.long()
        w = probs.gather(1, ids)
    w = w * c["routed_scaling_factor"]
    y = torch.zeros_like(x)
    ex = lp["experts"]
    for e in range(c["n_routed_experts"]):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        he = F.silu(xe @ ex["gate"]["w"][e].float()) * (xe @ ex["up"]["w"][e].float())
        y.index_add_(0, rows, (he @ ex["down"]["w"][e].float()) * w[rows, slot, None])
    return y + swiglu(lp["shared"], x), ids, probs


def backbone(params, x, c, mask=None):
    """x (B, T, D) -> (hidden after the final norm, [per MoE layer: (ids
    (B, T, k), router probabilities (B, T, E))]). mask (B|1, T, T) bool,
    default causal."""
    exact_fp32()
    b, t, d = x.shape
    if mask is None:
        mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()[None]
    eps = c["rms_norm_eps"]
    h = x.float()
    routes = []
    for i in range(c["num_hidden_layers"]):
        lp = params["layers"][i]
        h = h + attention(lp, rms_norm(lp["ln1"], h, eps), mask, c)
        a = rms_norm(lp["ln2"], h, eps)
        if i < c["first_k_dense_replace"]:
            h = h + swiglu(lp["mlp"], a)
            continue
        y, ids, probs = moe(lp, a.reshape(b * t, d), c)
        routes.append((ids.view(b, t, -1), probs.view(b, t, -1)))
        h = h + y.view(b, t, d)
    return rms_norm(params["norm"], h, eps), routes
