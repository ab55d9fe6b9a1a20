"""T3 on a DeepSeek-V2 backbone as one plain teacher-forced forward: the
logits that a served request's tokens were drawn from, and the router's
scores behind the experts it was served through.

The backbone follows the published modeling code (deepseek-ai/DeepSeek-V2-
Lite, `modeling_deepseek.py`), read from the published config.json's keys
(the configuration's t3.backbone): no q-LoRA; multi-head latent attention in its non-absorbed form
(k = [W_uk norm(c); k_pe], v = W_uv norm(c)), softmax scale 192^-0.5 x
mscale^2; YaRN RoPE on rope dims read as interleaved pairs; a dense SwiGLU
for the first `first_k_dense_replace` layers, then the fp32 softmax router,
its greedy top-k with weights not renormalised, a loop over the chosen
experts, and the shared experts. T3's part (conditioning, tables,
positions, CFG, the sampler's steps) is `reference/t3.py`'s.

Departures, none of which changes a value beyond the order of a sum: the
top-k is taken sorted (the published gate asks for it unsorted); the
router's choice may be forced, the weights then being the router's own
scores of the forced experts (the check forces the program's choice, so
that a near-tie that rounding flips costs nothing, and measures how far
each forced expert lies below the router's own k-th score). The layers'
weights come one at a time from `layer_of(i)`, so that the card holds one
layer in fp32 at a time.

`Prec` ("fp32"; "fp8" for the control) sets every matrix product's
operands, the router's and the experts' included.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import nn, t3
from .nn import FP32, Prec


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) / (2 * math.log(base))


def yarn_inv_freq(cb: dict) -> torch.Tensor:
    """DeepseekV2YarnRotaryEmbedding's inv_freq, in torch fp32 as published."""
    rs, dim, base = cb["rope_scaling"], cb["qk_rope_head_dim"], cb["rope_theta"]
    pw = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    extra, inter = 1.0 / pw, 1.0 / (rs["factor"] * pw)
    orig = rs["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rs["beta_fast"], dim, base, orig)), 0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], dim, base, orig)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(cb: dict) -> float:
    m = yarn_mscale(cb["rope_scaling"]["factor"], cb["rope_scaling"]["mscale_all_dim"])
    return (cb["qk_nope_head_dim"] + cb["qk_rope_head_dim"]) ** -0.5 * m * m


def _rope(x, pos, cb):
    rs = cb["rope_scaling"]
    freqs = torch.outer(pos.float(), yarn_inv_freq(cb).to(x.device))
    emb = torch.cat([freqs, freqs], dim=-1)
    m = yarn_mscale(rs["factor"], rs["mscale"]) / yarn_mscale(rs["factor"], rs["mscale_all_dim"])
    cos, sin = (emb.cos() * m)[None, :, None], (emb.sin() * m)[None, :, None]
    b, t, h, d = x.shape
    x = x.reshape(b, t, h, d // 2, 2).transpose(4, 3).reshape(b, t, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _swiglu(p, x, prec):
    return nn.linear(p["down"], F.silu(nn.linear(p["gate"], x, prec))
                     * nn.linear(p["up"], x, prec), prec)


def attention(lp, x, mask, cb, prec: Prec = FP32):
    """x (B, T, D) normed; mask (B|1, T, T) bool: the non-absorbed MLA."""
    b, t, _ = x.shape
    h, nope, rope, vd = (cb["num_attention_heads"], cb["qk_nope_head_dim"],
                         cb["qk_rope_head_dim"], cb["v_head_dim"])
    pos = torch.arange(t, device=x.device)
    q = nn.linear(lp["q"], x, prec).reshape(b, t, h, nope + rope)
    q_nope, q_pe = q.split([nope, rope], dim=-1)
    latent, k_pe = nn.linear(lp["kv_a"], x, prec).split([cb["kv_lora_rank"], rope], dim=-1)
    kv = nn.linear(lp["kv_b"], nn.rms_norm(lp["kv_norm"], latent, cb["rms_norm_eps"]), prec)
    k_nope, v = kv.reshape(b, t, h, nope + vd).split([nope, vd], dim=-1)
    qs = torch.cat([q_nope, _rope(q_pe, pos, cb)], dim=-1)
    ks = torch.cat([k_nope, _rope(k_pe.reshape(b, t, 1, rope), pos, cb).expand(b, t, h, rope)],
                   dim=-1)
    s = torch.einsum("bqhd,bkhd->bhqk", prec.q(qs), prec.q(ks)) * softmax_scale(cb)
    s = s.masked_fill(~mask[:, None], float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", prec.q(torch.softmax(s, dim=-1)), prec.q(v))
    return nn.linear(lp["o"], o.reshape(b, t, h * vd), prec)


def moe(lp, x, cb, prec: Prec = FP32, forced=None):
    """x (N, D) normed -> (y, ids (N, k), router probabilities (N, E))."""
    probs = torch.softmax(nn.linear(lp["router"], x, prec), dim=-1)
    if forced is None:
        w, ids = torch.topk(probs, cb["num_experts_per_tok"], dim=-1)
    else:
        ids = forced.long()
        w = probs.gather(1, ids)
    w = w * cb["routed_scaling_factor"]
    y = torch.zeros_like(x)
    ex = lp["experts"]
    for e in range(cb["n_routed_experts"]):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        he = (F.silu(prec.q(xe) @ prec.q(ex["gate"]["w"][e]))
              * (prec.q(xe) @ prec.q(ex["up"]["w"][e])))
        y.index_add_(0, rows, (prec.q(he) @ prec.q(ex["down"]["w"][e])) * w[rows, slot, None])
    return y + _swiglu(lp["shared"], x, prec), ids, probs


def backbone(layer_of, norm, x, cb: dict, mask, prec: Prec = FP32, forced=None):
    """x (B, T, D) -> (hidden after the final norm, [per MoE layer: (ids
    (B, T, k), probabilities (B, T, E))]). layer_of(i): layer i's params;
    forced: per MoE layer (B, T, k) ids."""
    b, t, d = x.shape
    eps = cb["rms_norm_eps"]
    h = x.float()
    routes = []
    for i in range(cb["num_hidden_layers"]):
        lp = layer_of(i)
        h = h + attention(lp, nn.rms_norm(lp["ln1"], h, eps), mask, cb, prec)
        a = nn.rms_norm(lp["ln2"], h, eps)
        if i < cb["first_k_dense_replace"]:
            h = h + _swiglu(lp["mlp"], a, prec)
        else:
            j = i - cb["first_k_dense_replace"]
            y, ids, probs = moe(lp, a.reshape(b * t, d), cb, prec,
                                None if forced is None else forced[j].reshape(b * t, -1))
            routes.append((ids.reshape(b, t, -1), probs.reshape(b, t, -1)))
            h = h + y.reshape(b, t, d)
        del lp
    return nn.rms_norm(norm, h, eps), routes


def served(p, layer_of, cfg: dict, requests: list, prec: Prec = FP32, forced=True):
    """The CFG logits (n, V) of each request, teacher-forced, and how far
    its forced experts lie below the router's k-th score.

    p: T3's tree without the backbone's layers (the backbone's final norm
    under p["llama"]["norm"]); layer_of(i): layer i. requests: [(voice,
    text ids, served speech ids, cfg_weight, routes)], routes (moe layers,
    positions, 2, k) the program's expert ids of the two rows (context and
    the fed-back tokens), or None. With `forced` the routes are taken;
    otherwise the reference routes itself. Returns ([mixed logits], [route
    gap of each request] (0 where it agrees), [its own routes (moe layers,
    positions, 2, k)])."""
    t3c, cb = cfg["t3"], cfg["t3"]["backbone"]
    dev = p["speech_emb"]["w"].device
    seqs, firsts, ns = [], [], []
    for voice, text, speech, _, _ in requests:
        tt = torch.as_tensor(np.asarray(text), dtype=torch.long, device=dev)
        st = torch.as_tensor(np.asarray(speech), dtype=torch.long, device=dev)
        n, lt = st.shape[0], tt.shape[0]
        ce = t3.cond_embeds(p, t3c, voice, prec)[0]
        tpos = p["text_pos_emb"]["w"][:lt].float()
        spos = p["speech_pos_emb"]["w"].float()
        bos = p["speech_emb"]["w"][t3c["start_speech_token"]].float() + spos[0]
        sp = p["speech_emb"]["w"][st[:-1]].float() + spos[1:n]
        te = p["text_emb"]["w"][tt].float()
        seqs += [torch.cat([ce, te + tpos, bos[None], bos[None], sp]),
                 torch.cat([ce, tpos, bos[None], bos[None], sp])]
        firsts.append(ce.shape[0] + lt + 1)
        ns.append(n)
    t_max = max(s.shape[0] for s in seqs)
    x = torch.stack([F.pad(s, (0, 0, 0, t_max - s.shape[0])) for s in seqs])
    k = cb["num_experts_per_tok"]
    moe_layers = cb["num_hidden_layers"] - cb["first_k_dense_replace"]
    force = None
    if forced:
        force = torch.zeros((moe_layers, x.shape[0], t_max, k), dtype=torch.long, device=dev)
        force[...] = torch.arange(k, device=dev)
        for r, req in enumerate(requests):
            rt = torch.as_tensor(np.asarray(req[4], np.int64), device=dev)   # (L, P, 2, k)
            force[:, 2 * r:2 * r + 2, :rt.shape[1]] = rt.permute(0, 2, 1, 3)
    causal = torch.ones((t_max, t_max), dtype=torch.bool, device=dev).tril()[None]
    h, routes = backbone(layer_of, p["llama"]["norm"], x, cb, causal, prec, force)
    logits, gaps, own = [], [], []
    for r, (req, first, n) in enumerate(zip(requests, firsts, ns)):
        rows = h[2 * r:2 * r + 2, first:first + n]
        lg = nn.linear(p["speech_head"], rows, prec)
        mixed = lg[0] + req[3] * (lg[0] - lg[1])
        ids = torch.arange(mixed.shape[-1], device=dev)
        ok = (ids < t3c["start_speech_token"]) | (ids == t3c["stop_speech_token"])
        logits.append(mixed.masked_fill(~ok, float("-inf")))
        length = first + n                   # the context and the n - 1 tokens fed back
        gap = 0.0
        for ids_j, probs_j in routes:
            pr = probs_j[2 * r:2 * r + 2, :length]
            kth = pr.topk(k, dim=-1).values[..., -1:]
            chosen = pr.gather(-1, ids_j[2 * r:2 * r + 2, :length])
            gap = max(gap, float((kth - chosen).clamp_min(0).max()))
        gaps.append(gap)
        own.append(torch.stack([ids_j[2 * r:2 * r + 2, :length].permute(1, 0, 2)
                                for ids_j, _ in routes]).cpu().numpy())
    return logits, gaps, own
