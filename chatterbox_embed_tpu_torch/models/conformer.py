"""Upsampling conformer encoder for the S3Gen flow (25 Hz token embeddings ->
50 Hz mel-rate features), the PyTorch counterpart of
`chatterbox_embed_tpu/models/conformer.py`.

Linear embed + relative PE, a 3-frame pre-lookahead conv, N conformer blocks
(rel-pos MHA + FFN, pre-norm), nearest x2 upsample with a causal conv, M more
blocks, final LayerNorm. The Transformer-XL bd term is factored by the sine
angle-addition identity (`_rel_factors`). Below 4 rows (a single utterance)
both score terms are plain matmuls; from 4 rows the whole masked attention
runs in the rel-attention kernel over the augmented features, as the JAX
package gates it (`kernels/rel_attention.py`; on the CPU its plain version).
Its LayerNorms are one launch each (`kernels/layer_norm.py`, K8).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ConformerConfig
from ..device import constant
from ..kernels.layer_norm import layer_norm
from ..kernels.rel_attention import rel_attention
from . import layers as L


def init(init: L.Init, cfg: ConformerConfig = ConformerConfig()):
    d, h = cfg.output_size, cfg.attention_heads

    def block_init():
        return {
            "norm_mha": L.layer_norm_init(init, d),
            "q": L.linear_init(init, d, d),
            "k": L.linear_init(init, d, d),
            "v": L.linear_init(init, d, d),
            "o": L.linear_init(init, d, d),
            "pos": L.linear_init(init, d, d, bias=False),
            "pos_bias_u": init.uniform((h, d // h), math.sqrt(6 / (2 * d // h))),
            "pos_bias_v": init.uniform((h, d // h), math.sqrt(6 / (2 * d // h))),
            "norm_ff": L.layer_norm_init(init, d),
            "ff1": L.linear_init(init, d, cfg.linear_units),
            "ff2": L.linear_init(init, cfg.linear_units, d),
        }

    return {
        "embed": {"lin": L.linear_init(init, cfg.input_size, d),
                  "ln": L.layer_norm_init(init, d)},
        "lookahead": {"conv1": L.conv1d_init(init, cfg.pre_lookahead_len + 1, d, d),
                      "conv2": L.conv1d_init(init, 3, d, d)},
        "blocks": [block_init() for _ in range(cfg.num_blocks)],
        "up_conv": L.conv1d_init(init, cfg.upsample_stride * 2 + 1, d, d),
        "up_embed": {"lin": L.linear_init(init, cfg.input_size, d),
                     "ln": L.layer_norm_init(init, d)},
        "up_blocks": [block_init() for _ in range(cfg.num_up_blocks)],
        "after_norm": L.layer_norm_init(init, d),
    }


def _rel_trig(t: int, d: int):
    """(t, d/2) sin/cos tables at the espnet PE frequencies (numpy fp32)."""
    div = np.exp(np.arange(0, d, 2, dtype=np.float32) * -(math.log(10_000.0) / d))
    ang = np.arange(t, dtype=np.float32)[:, None] * div
    return np.sin(ang), np.cos(ang)


def _rel_factors(p, qv, n_heads, sin_t, cos_t):
    """Factor the Transformer-XL bd term:

      bd[i,j] = (q[i]+v) . pe_proj[(T-1)-i+j] = A[i] . C[j] + B[i] . S[j]

    with g[i] = W_pos_h^T (q[i]+v) and A/B the angle-addition recombination
    of g with the i-side trig tables. Returns A, B of shape (B, T, H, d/2)."""
    b, t, h, dk = qv.shape
    d = h * dk
    w_pos = p["pos"]["w"].reshape(d, h, dk)                  # (d, H, dk)
    g = torch.einsum("bihc,mhc->bihm", qv, w_pos.to(qv.dtype))  # (B, T, H, d)
    sin_i = sin_t[None, :, None, :].to(g.dtype)
    cos_i = cos_t[None, :, None, :].to(g.dtype)
    g_sin, g_cos = g[..., 0::2], g[..., 1::2]
    a = g_sin * sin_i + g_cos * cos_i
    bb = -g_sin * cos_i + g_cos * sin_i
    return a, bb


def _rel_attention(p, x, trig, pad_mask, n_heads, dtype):
    """Scores (q+u)k^T + bd via the factored rel-pos form, masked fp32
    softmax, weights of masked keys zeroed."""
    b, t, d = x.shape
    dk = d // n_heads
    q = L.split_heads(L.linear(p["q"], x, dtype), n_heads)   # (B, T, H, dk)
    k = L.split_heads(L.linear(p["k"], x, dtype), n_heads)
    v = L.split_heads(L.linear(p["v"], x, dtype), n_heads)
    sin_t, cos_t = trig

    qu = q + p["pos_bias_u"].to(q.dtype)
    qv = q + p["pos_bias_v"].to(q.dtype)
    a, bb = _rel_factors(p, qv, n_heads, sin_t, cos_t)       # (B, T, H, d/2)

    if b >= 4:
        # one augmented product [qu|A|B] . [k|C|S]^T with the masked softmax
        # and p.v in the rel-attention kernel: the (B, H, T, T) scores never
        # reach device memory
        cs = torch.cat([cos_t, sin_t], dim=-1).to(k.dtype)
        cs = cs[None, :, None, :].expand(b, t, n_heads, d)
        q_aug = torch.cat([qu, a.to(q.dtype), bb.to(q.dtype)], dim=-1)
        k_aug = torch.cat([k, cs], dim=-1)
        kv_mask = (pad_mask if pad_mask is not None
                   else torch.ones((b, t), dtype=torch.bool, device=x.device))
        out = rel_attention(q_aug, k_aug, v, kv_mask.contiguous(), 1.0 / math.sqrt(dk))
        return L.linear(p["o"], L.merge_heads(out), dtype)

    ac = torch.einsum("bqhd,bkhd->bhqk", qu.float(), k.float())
    bd = (torch.einsum("bihm,jm->bhij", a.float(), cos_t.to(a.dtype).float())
          + torch.einsum("bihm,jm->bhij", bb.float(), sin_t.to(a.dtype).float()))
    logits = (ac + bd) / math.sqrt(dk)
    if pad_mask is not None:
        km = pad_mask[:, None, None, :]
        logits = logits.masked_fill(~km, float("-inf"))
        w = torch.softmax(logits, dim=-1)
        w = w.masked_fill(~km, 0.0)
    else:
        w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)
    return L.linear(p["o"], L.merge_heads(out), dtype)


def _conformer_block(p, x, trig, pad_mask, n_heads, eps, dtype):
    h = layer_norm(p["norm_mha"], x, eps)
    x = x + _rel_attention(p, h, trig, pad_mask, n_heads, dtype)
    h = layer_norm(p["norm_ff"], x, eps)
    h = L.linear(p["ff2"], F.silu(L.linear(p["ff1"], h, dtype)), dtype)
    return x + h


def _lookahead(p, x, pre_len, dtype):
    """Right-context conv + causal conv with residual."""
    h = L.conv1d(p["conv1"], x, padding=(0, pre_len), dtype=dtype)
    h = F.leaky_relu(h, 0.01)
    h = L.conv1d(p["conv2"], h, padding=(2, 0), dtype=dtype)
    return x + h


def _trig(t, d, device):
    """The rel-pos sin and cos tables of width t on `device`, copied once."""
    return (constant(("conformer_sin", t, d), device, lambda: _rel_trig(t, d)[0]),
            constant(("conformer_cos", t, d), device, lambda: _rel_trig(t, d)[1]))


def forward(params, x: torch.Tensor, lens: torch.Tensor | None = None,
            cfg: ConformerConfig = ConformerConfig(), dtype=torch.float32):
    """x: (B, T, 512) embedded tokens -> (B, 2T, 512) mel-rate features."""
    b, t, _ = x.shape
    dev = x.device
    pad_mask = None if lens is None else (torch.arange(t, device=dev)[None] < lens[:, None])

    xscale = math.sqrt(cfg.output_size)
    h = layer_norm(params["embed"]["ln"],
                   L.linear(params["embed"]["lin"], x.to(dtype), dtype),
                   cfg.embed_ln_eps) * xscale
    if pad_mask is not None:
        # zero pad positions so bucketed inference equals exact-length
        # inference: the lookahead conv's right context sees zeros either way
        h = h * pad_mask[..., None].to(h.dtype)
    trig = _trig(t, cfg.output_size, dev)

    h = _lookahead(params["lookahead"], h, cfg.pre_lookahead_len, dtype)
    for blk in params["blocks"]:
        h = _conformer_block(blk, h, trig, pad_mask, cfg.attention_heads, cfg.ln_eps, dtype)

    # nearest x2 upsample + left-padded conv
    s = cfg.upsample_stride
    h = torch.repeat_interleave(h, s, dim=1)
    h = F.pad(h, (0, 0, 2 * s, 0))
    h = L.conv1d(params["up_conv"], h, padding="VALID", dtype=dtype)

    t2 = h.shape[1]
    pad_mask2 = None if lens is None else (torch.arange(t2, device=dev)[None] < (lens * s)[:, None])
    h = layer_norm(params["up_embed"]["ln"],
                   L.linear(params["up_embed"]["lin"], h, dtype),
                   cfg.embed_ln_eps) * xscale
    if pad_mask2 is not None:
        h = h * pad_mask2[..., None].to(h.dtype)
    trig2 = _trig(t2, cfg.output_size, dev)
    for blk in params["up_blocks"]:
        h = _conformer_block(blk, h, trig2, pad_mask2, cfg.attention_heads, cfg.ln_eps, dtype)

    return layer_norm(params["after_norm"], h, cfg.embed_ln_eps)
