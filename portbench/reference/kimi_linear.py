"""T3 on a Kimi-Linear backbone as one plain teacher-forced forward: the
logits that a served request's tokens were drawn from, and the router's
scores behind the experts it was served through.

The backbone follows the published modeling code (moonshotai/Kimi-Linear-
48B-A3B-Instruct, `modeling_kimi.py`, and fla's KimiDeltaAttention with its
naive recurrence), read from the published config.json's keys (the
configuration's t3.backbone):

- layer kinds from `linear_attn_config`: the 1-indexed `kda_layers` and
  `full_attn_layers`;
- a KDA layer: q, k, v projections, a causal depthwise conv1d of
  `short_conv_kernel_size` (no bias) and SiLU; q and k L2-normalised per
  head (x / sqrt(sum x^2 + 1e-6)), q / sqrt(dk); beta = sigmoid(W_b x); g =
  -exp(A_log) softplus(W_fb W_fa x + dt_bias); the gated delta rule token
  by token on a zero fp32 state, S' = Diag(exp(g_t)) S, S = S' + beta_t k_t
  (v_t - S'^T k_t)^T, o_t = S^T q_t; the per-head RMSNorm of o times
  sigmoid(W_gb W_ga x), then W_o;
- an MLA layer: DeepSeek-V2's non-absorbed latent attention with
  `mla_use_nope`, no rotation, softmax scale (nope + rope)^-1/2;
- pre-norm RMSNorm, a dense SwiGLU for the first `first_k_dense_replace`
  layers, then MoE: sigmoid scores over the `published_num_experts` routed
  experts, the top k of score + e_score_correction_bias (one group), the
  chosen scores renormalised (+1e-20) x routed_scaling_factor, a loop over
  the held experts 0 .. num_experts - 1 (the absent ones' parts left out,
  as the program leaves them out), one shared SwiGLU.

T3's part (conditioning, tables, positions, CFG, the sampler's steps) is
`reference/t3.py`'s. Departures, none of which changes a value beyond the
order of a sum: the router's choice may be forced, the weights then being
the renormalised scores of the forced experts (the check forces the
program's choice, so that a near-tie that rounding flips costs nothing,
and measures how far each forced expert's choice score lies below the
router's own k-th); the layers' weights come one at a time from
`layer_of(i)`, so that the card holds one layer in fp32 at a time.

`Prec` ("fp32"; "fp8" for the control) sets every matrix product's and the
conv's operands; the recurrence and the router's scores stay fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import nn, t3
from .nn import FP32, Prec


def _swiglu(p, x, prec):
    return nn.linear(p["down"], F.silu(nn.linear(p["gate"], x, prec))
                     * nn.linear(p["up"], x, prec), prec)


def kda(p, x, cb, prec: Prec = FP32, keep=None):
    """x (B, T, D) normed -> (the KDA layer's output (B, T, D), the state
    (B, H, dk, dv) of each row b after its position keep[b], or None
    without `keep`)."""
    la = cb["linear_attn_config"]
    h, dk, kk = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    b, t, _ = x.shape
    pre = torch.cat([nn.linear(p["q"], x, prec), nn.linear(p["k"], x, prec),
                     nn.linear(p["v"], x, prec)], dim=-1)
    w = p["conv"]["w"].t()[:, None, :]                     # (C, 1, K), as Conv1d holds it
    y = F.conv1d(F.pad(prec.q(pre).transpose(1, 2), (kk - 1, 0)), prec.q(w),
                 groups=pre.shape[-1])
    q, k, v = F.silu(y.transpose(1, 2)).reshape(b, t, 3 * h, dk).split(h, dim=2)
    q = q / torch.sqrt(q.square().sum(-1, keepdim=True) + 1e-6) / dk ** 0.5
    k = k / torch.sqrt(k.square().sum(-1, keepdim=True) + 1e-6)
    beta = torch.sigmoid(nn.linear(p["b"], x, prec))
    f = nn.linear(p["f_b"], nn.linear(p["f_a"], x, prec), prec).reshape(b, t, h, dk)
    dt_bias = p["dt_bias"].float().reshape(h, dk)
    g = -torch.exp(p["A_log"].float())[:, None] * F.softplus(f + dt_bias)
    s = torch.zeros((b, h, dk, v.shape[-1]), device=x.device)
    kept = None if keep is None else torch.zeros_like(s)
    outs = []
    for i in range(t):
        s = s * torch.exp(g[:, i])[..., None]
        err = v[:, i] - torch.einsum("bhk,bhkv->bhv", k[:, i], s)
        s = s + k[:, i, :, :, None] * (beta[:, i, :, None] * err)[:, :, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", q[:, i], s))
        if keep is not None:
            kept = torch.where((keep == i)[:, None, None, None], s, kept)
    o = torch.stack(outs, dim=1)
    gate = nn.linear(p["g_b"], nn.linear(p["g_a"], x, prec), prec).reshape(b, t, h, dk)
    o = nn.rms_norm(p["o_norm"], o, cb["rms_norm_eps"]) * torch.sigmoid(gate)
    return nn.linear(p["o"], o.reshape(b, t, h * dk), prec), kept


def mla(lp, x, mask, cb, prec: Prec = FP32):
    """x (B, T, D) normed; mask (B|1, T, T) bool: latent attention, unrotated."""
    b, t, _ = x.shape
    h, nope, rope, vd = (cb["num_attention_heads"], cb["qk_nope_head_dim"],
                         cb["qk_rope_head_dim"], cb["v_head_dim"])
    q = nn.linear(lp["q"], x, prec).reshape(b, t, h, nope + rope)
    latent, k_pe = nn.linear(lp["kv_a"], x, prec).split([cb["kv_lora_rank"], rope], dim=-1)
    kv = nn.linear(lp["kv_b"], nn.rms_norm(lp["kv_norm"], latent, cb["rms_norm_eps"]), prec)
    k_nope, v = kv.reshape(b, t, h, nope + vd).split([nope, vd], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, t, h, rope)], dim=-1)
    s = torch.einsum("bqhd,bkhd->bhqk", prec.q(q), prec.q(k)) * (nope + rope) ** -0.5
    s = s.masked_fill(~mask[:, None], float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", prec.q(torch.softmax(s, dim=-1)), prec.q(v))
    return nn.linear(lp["o"], o.reshape(b, t, h * vd), prec)


def moe(lp, x, cb, prec: Prec = FP32, forced=None):
    """x (N, D) normed -> (y, ids (N, k), choice scores (N, E): sigmoid
    score + correction bias)."""
    s = torch.sigmoid(nn.linear(lp["router"], x, prec))
    choice = s + lp["router"]["e_score_correction_bias"].float()
    ids = (torch.topk(choice, cb["num_experts_per_token"], dim=-1).indices if forced is None
           else forced.long())
    w = s.gather(1, ids)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cb["routed_scaling_factor"]
    y = torch.zeros_like(x)
    ex = lp["experts"]
    for e in range(cb["num_experts"]):                       # the held experts
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        he = (F.silu(prec.q(xe) @ prec.q(ex["gate"]["w"][e]))
              * (prec.q(xe) @ prec.q(ex["up"]["w"][e])))
        y.index_add_(0, rows, (prec.q(he) @ prec.q(ex["down"]["w"][e])) * w[rows, slot, None])
    return y + _swiglu(lp["shared"], x, prec), ids, choice


def backbone(layer_of, norm, x, cb: dict, mask, prec: Prec = FP32, forced=None, keep=None):
    """x (B, T, D) -> (hidden after the final norm, [per MoE layer: (ids
    (B, T, k), choice scores (B, T, E))], [per KDA layer: each row's state
    after its position keep[b] (B, H, dk, dv), or None]). layer_of(i):
    layer i's params; mask (B|1, T, T) for the MLA layers (the KDA layers
    run every position in order); forced: per MoE layer (B, T, k) ids."""
    b, t, d = x.shape
    eps = cb["rms_norm_eps"]
    kda_layers = set(cb["linear_attn_config"]["kda_layers"])
    h = x.float()
    routes, states = [], []
    for i in range(cb["num_hidden_layers"]):
        lp = layer_of(i)
        a = nn.rms_norm(lp["ln1"], h, eps)
        if i + 1 in kda_layers:
            y, st = kda(lp["kda"], a, cb, prec, keep)
            states.append(st)
        else:
            y = mla(lp, a, mask, cb, prec)
        h = h + y
        a = nn.rms_norm(lp["ln2"], h, eps)
        if i < cb["first_k_dense_replace"]:
            h = h + _swiglu(lp["mlp"], a, prec)
        else:
            j = i - cb["first_k_dense_replace"]
            y, ids, choice = moe(lp, a.reshape(b * t, d), cb, prec,
                                 None if forced is None else forced[j].reshape(b * t, -1))
            routes.append((ids.reshape(b, t, -1), choice.reshape(b, t, -1)))
            h = h + y.reshape(b, t, d)
        del lp
    return nn.rms_norm(norm, h, eps), routes, states


def served(p, layer_of, cfg: dict, requests: list, prec: Prec = FP32, forced=True,
           steps=None):
    """The CFG logits (n, V) of each request, teacher-forced, and how far its
    forced experts' choice scores lie below the router's k-th; with `steps`
    (a decode step count a request), the KDA layers' states of its two rows
    after its context and that many fed-back tokens.

    p: T3's tree without the backbone's layers (the final norm under
    p["llama"]["norm"]); layer_of(i): layer i. requests: [(voice, text ids,
    served speech ids, cfg_weight, routes)], routes (moe layers, positions,
    2, k) the program's expert ids of the two rows (context and the fed-back
    tokens), or None. With `forced` the routes are taken; otherwise the
    reference routes itself. Returns ([mixed logits], [route gap of each
    request] (0 where it agrees), [its own routes (moe layers, positions,
    2, k)], [its states (kda layers, 2, H, dk, dv)] or None without
    `steps`)."""
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
    # right-padded to the longest: a position sees only those before it
    x = torch.stack([F.pad(s, (0, 0, 0, t_max - s.shape[0])) for s in seqs])
    k = cb["num_experts_per_token"]
    moe_layers = cb["num_hidden_layers"] - cb["first_k_dense_replace"]
    force = None
    if forced:
        force = torch.zeros((moe_layers, x.shape[0], t_max, k), dtype=torch.long, device=dev)
        force[...] = torch.arange(k, device=dev)
        for r, req in enumerate(requests):
            rt = torch.as_tensor(np.asarray(req[4], np.int64), device=dev)   # (L, P, 2, k)
            force[:, 2 * r:2 * r + 2, :rt.shape[1]] = rt.permute(0, 2, 1, 3)
    keep = None
    if steps is not None:
        keep = torch.tensor([f + m for f, m in zip(firsts, steps) for _ in range(2)],
                            device=dev)
    causal = torch.ones((t_max, t_max), dtype=torch.bool, device=dev).tril()[None]
    h, routes, states = backbone(layer_of, p["llama"]["norm"], x, cb, causal, prec, force, keep)
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
        for ids_j, choice_j in routes:
            ch = choice_j[2 * r:2 * r + 2, :length]
            kth = ch.topk(k, dim=-1).values[..., -1:]
            chosen = ch.gather(-1, ids_j[2 * r:2 * r + 2, :length])
            gap = max(gap, float((kth - chosen).clamp_min(0).max()))
        gaps.append(gap)
        own.append(torch.stack([ids_j[2 * r:2 * r + 2, :length].permute(1, 0, 2)
                                for ids_j, _ in routes]).cpu().numpy())
    kept = None
    if steps is not None:
        kept = [torch.stack([st[2 * r:2 * r + 2] for st in states]) for r in range(len(requests))]
    return logits, gaps, own, kept
