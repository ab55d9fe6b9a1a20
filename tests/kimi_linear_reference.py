"""A plain fp32 PyTorch reference of the Kimi-Linear backbone for the CPU
tests: read from a published-style config.json dict, written from the
published equations (modeling_kimi.py, fla's KimiDeltaAttention and
naive_recurrent_kda) and not from the port, importing neither the port nor
JAX. Parameters are nested dicts in the port's tree layout (a linear
{"w": (in, out)}, a norm {"scale"}).

- KDA: q, k, v projections, a causal depthwise conv1d (F.conv1d, groups =
  channels, left padding) and SiLU, q and k L2-normalised (q / sqrt(dk)),
  beta = sigmoid(W_b x), g = -exp(A_log) softplus(W_fb W_fa x + dt_bias),
  the delta rule token by token from a zero state, the gated RMSNorm and
  W_o.
- MLA without rotation (mla_use_nope): k = [W_uk norm(c); k_pe], v = W_uv
  norm(c), scale (nope + rope)^-1/2.
- MoE: sigmoid scores, the top k of score + e_score_correction_bias, the
  chosen scores renormalised x routed_scaling_factor, a loop over the held
  experts [lo, hi) (the params hold those alone), one shared SwiGLU.
"""
import torch
import torch.nn.functional as F


def rms(x, scale, eps):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def swiglu(p, x):
    return (F.silu(x @ p["gate"]["w"]) * (x @ p["up"]["w"])) @ p["down"]["w"]


def kda(p, x, c, state=None):
    """x (B, T, D) normed -> (out (B, T, D), final state (B, H, dk, dv))."""
    la = c["linear_attn_config"]
    h, dk, kk = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    b, t, _ = x.shape
    pre = torch.cat([x @ p["q"]["w"], x @ p["k"]["w"], x @ p["v"]["w"]], dim=-1)
    w = p["conv"]["w"].t()[:, None, :]                       # (C, 1, K) as Conv1d holds it
    y = F.conv1d(F.pad(pre.transpose(1, 2), (kk - 1, 0)), w, groups=pre.shape[-1])
    q, k, v = F.silu(y.transpose(1, 2)).reshape(b, t, 3 * h, dk).split(h, dim=2)
    q = q / torch.sqrt(q.square().sum(-1, keepdim=True) + 1e-6) / dk ** 0.5
    k = k / torch.sqrt(k.square().sum(-1, keepdim=True) + 1e-6)
    beta = torch.sigmoid(x @ p["b"]["w"])
    f = (x @ p["f_a"]["w"] @ p["f_b"]["w"]).reshape(b, t, h, dk)
    g = -torch.exp(p["A_log"])[:, None] * F.softplus(f + p["dt_bias"].reshape(h, dk))
    s = torch.zeros(b, h, dk, dk) if state is None else state.clone()
    outs = []
    for i in range(t):
        s = s * torch.exp(g[:, i])[..., None]
        err = v[:, i] - torch.einsum("bhk,bhkv->bhv", k[:, i], s)
        s = s + torch.einsum("bhk,bhv->bhkv", k[:, i], beta[:, i, :, None] * err)
        outs.append(torch.einsum("bhk,bhkv->bhv", q[:, i], s))
    o = torch.stack(outs, dim=1)
    gate = (x @ p["g_a"]["w"] @ p["g_b"]["w"]).reshape(b, t, h, dk)
    o = rms(o, p["o_norm"]["scale"], c["rms_norm_eps"]) * torch.sigmoid(gate)
    return o.reshape(b, t, h * dk) @ p["o"]["w"], s


def mla(lp, x, c, mask):
    b, t, _ = x.shape
    h, nope, rope, vd = (c["num_attention_heads"], c["qk_nope_head_dim"],
                         c["qk_rope_head_dim"], c["v_head_dim"])
    q = (x @ lp["q"]["w"]).reshape(b, t, h, nope + rope)
    latent, k_pe = (x @ lp["kv_a"]["w"]).split([c["kv_lora_rank"], rope], dim=-1)
    kv = rms(latent, lp["kv_norm"]["scale"], c["rms_norm_eps"]) @ lp["kv_b"]["w"]
    k_nope, v = kv.reshape(b, t, h, nope + vd).split([nope, vd], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(b, t, h, rope)], dim=-1)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (nope + rope) ** -0.5
    s = s.masked_fill(~mask[:, None], float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return o.reshape(b, t, h * vd) @ lp["o"]["w"]


def route(lp, x, c):
    """(ids (N, k), weights (N, k), scores (N, E), choice scores (N, E))."""
    s = torch.sigmoid(x @ lp["router"]["w"])
    choice = s + lp["router"]["e_score_correction_bias"]
    ids = torch.topk(choice, c["num_experts_per_token"], dim=-1).indices
    w = s.gather(1, ids)
    return ids, w / (w.sum(-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"], s, choice


def moe(lp, x, c, held=None, forced=None):
    """x (N, D) normed -> (y, ids, choice scores); held (lo, hi): the
    experts the params hold, the others' parts left out."""
    ids, w, s, choice = route(lp, x, c)
    if forced is not None:
        ids = forced.long()
        w = s.gather(1, ids)
        w = w / (w.sum(-1, keepdim=True) + 1e-20) * c["routed_scaling_factor"]
    lo, hi = held or (0, lp["experts"]["gate"]["w"].shape[0])
    y = torch.zeros_like(x)
    ex = lp["experts"]
    for e in range(lo, hi):
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        if rows.numel():
            he = F.silu(x[rows] @ ex["gate"]["w"][e - lo]) * (x[rows] @ ex["up"]["w"][e - lo])
            y.index_add_(0, rows, (he @ ex["down"]["w"][e - lo]) * w[rows, slot, None])
    return y + swiglu(lp["shared"], x), ids, choice


def backbone(params, x, c, mask=None, held=None, forced=None):
    """x (B, T, D) -> (hidden after the final norm, [per MoE layer: (ids (B,
    T, k), choice scores (B, T, E))]); mask (B|1, T, T) for the MLA layers
    (default causal); the KDA layers see every position."""
    b, t, d = x.shape
    eps = c["rms_norm_eps"]
    kda_layers = set(c["linear_attn_config"]["kda_layers"])
    if mask is None:
        mask = torch.ones(t, t, dtype=torch.bool).tril()[None]
    h = x.float()
    routes = []
    for i, lp in enumerate(params["layers"]):
        a = rms(h, lp["ln1"]["scale"], eps)
        h = h + (kda(lp["kda"], a, c)[0] if i + 1 in kda_layers else mla(lp, a, c, mask))
        a = rms(h, lp["ln2"]["scale"], eps)
        if i < c["first_k_dense_replace"]:
            h = h + swiglu(lp["mlp"], a)
        else:
            j = i - c["first_k_dense_replace"]
            y, ids, choice = moe(lp, a.reshape(b * t, d), c, held,
                                 None if forced is None else forced[j].reshape(b * t, -1))
            routes.append((ids.reshape(b, t, -1), choice.reshape(b, t, -1)))
            h = h + y.reshape(b, t, d)
    return rms(h, params["norm"]["scale"], eps), routes
