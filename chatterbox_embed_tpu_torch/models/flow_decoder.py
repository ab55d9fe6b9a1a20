"""CFM estimator: a causal 1-D U-Net predicting the flow velocity field, the
PyTorch counterpart of `chatterbox_embed_tpu/models/flow_decoder.py`.

1 down-stage + N mid-stages + 1 up-stage, each a causal resnet followed by
transformer blocks, all at full mel rate, channel-last. Attention in the
transformer blocks has a key mask; it is written out (layers.mha) below 4
rows and runs in the flash-attention kernel (layers.mha_flash) from 4 rows,
as the JAX package gates it.

Under `comm` (parallel/sp.py:SeqComm) the call runs on one shard of the T
axis, on every rank of an sp mesh: each causal k=3 conv prepends a 2-frame
halo from the left neighbour (zeros on the first shard, the causal pad),
K/V are gathered over sp, and the key mask is gathered once a call. The
attention there is the plain `layers.mha` of this shard's queries against
the gathered keys, as the JAX package computes it (XLA): the kernel K3
takes as many keys as queries.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import FlowDecoderConfig
from . import layers as L


def init(init: L.Init, cfg: FlowDecoderConfig = FlowDecoderConfig()):
    c = cfg.channels
    inner = cfg.num_heads * cfg.attention_head_dim

    def causal_block(d_in, d_out):
        return {"conv": L.conv1d_init(init, 3, d_in, d_out),
                "ln": L.layer_norm_init(init, d_out)}

    def resnet(d_in, d_out):
        return {
            "mlp": L.linear_init(init, cfg.time_embed_dim, d_out),
            "block1": causal_block(d_in, d_out),
            "block2": causal_block(d_out, d_out),
            "res_conv": L.conv1d_init(init, 1, d_in, d_out),
        }

    def tblock():
        return {
            "ln1": L.layer_norm_init(init, c),
            "q": L.linear_init(init, c, inner, bias=False),
            "k": L.linear_init(init, c, inner, bias=False),
            "v": L.linear_init(init, c, inner, bias=False),
            "o": L.linear_init(init, inner, c),
            "ln3": L.layer_norm_init(init, c),
            "ff1": L.linear_init(init, c, 4 * c),
            "ff2": L.linear_init(init, 4 * c, c),
        }

    def stage(d_in, d_out):
        return {"resnet": resnet(d_in, d_out),
                "tblocks": [tblock() for _ in range(cfg.n_blocks)]}

    return {
        "time_mlp": {"lin1": L.linear_init(init, cfg.in_channels, cfg.time_embed_dim),
                     "lin2": L.linear_init(init, cfg.time_embed_dim, cfg.time_embed_dim)},
        "down": {**stage(cfg.in_channels, c), "downsample": L.conv1d_init(init, 3, c, c)},
        "mid": [stage(c, c) for _ in range(cfg.num_mid_blocks)],
        "up": {**stage(2 * c, c), "upsample": L.conv1d_init(init, 3, c, c)},
        "final_block": causal_block(c, c),
        "final_proj": L.conv1d_init(init, 1, c, cfg.out_channels),
    }


def _sinusoidal_t(t, dim, scale=1000.0):
    """(B,) diffusion timestep -> (B, dim) embedding."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1))
    ang = scale * t[:, None].float() * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _causal_conv3(p, xm, dtype, comm=None):
    """k=3 causal conv on a pre-masked input: left-pad 2 zeros; under
    `comm` the 2 frames before this shard instead (zeros on the first
    shard), so the sharded conv equals the unsharded one."""
    if comm is None:
        return L.conv1d(p, xm, padding=(2, 0), dtype=dtype)
    return L.conv1d(p, comm.halo(xm, 2), padding=(0, 0), dtype=dtype)


def _causal_block(p, x, mask, dtype, comm=None):
    """causal conv(k3) -> LayerNorm -> Mish, masked."""
    h = _causal_conv3(p["conv"], x * mask, dtype, comm)
    h = L.layer_norm(p["ln"], h)
    return L.mish(h) * mask


def _resnet(p, x, mask, t_emb, dtype, comm=None):
    h = _causal_block(p["block1"], x, mask, dtype, comm)
    h = h + L.linear(p["mlp"], L.mish(t_emb), dtype)[:, None, :]
    h = _causal_block(p["block2"], h, mask, dtype, comm)
    return h + L.conv1d(p["res_conv"], x * mask, dtype=dtype)


def _tblock(p, x, n_heads, dtype, key_mask=None, comm=None):
    h = L.layer_norm(p["ln1"], x)
    q = L.split_heads(L.linear(p["q"], h, dtype), n_heads)
    k = L.split_heads(L.linear(p["k"], h, dtype), n_heads)
    v = L.split_heads(L.linear(p["v"], h, dtype), n_heads)
    if comm is not None:
        # this shard's queries against every shard's keys; key_mask is
        # already the whole T (gathered once in forward)
        attn = L.mha(q, comm.gather(k), comm.gather(v), mask=key_mask)
    elif L.use_flash_attention(x.shape[0]):
        attn = L.mha_flash(q, k, v, None if key_mask is None else key_mask[:, 0, 0, :])
    else:
        attn = L.mha(q, k, v, mask=key_mask)
    x = x + L.linear(p["o"], L.merge_heads(attn), dtype)
    h = L.layer_norm(p["ln3"], x)
    h = L.linear(p["ff2"], F.gelu(L.linear(p["ff1"], h, dtype)), dtype)
    return x + h


def _stage(p, x, mask, t_emb, n_heads, dtype, key_mask=None, comm=None):
    x = _resnet(p["resnet"], x, mask, t_emb, dtype, comm)
    for tb in p["tblocks"]:
        x = _tblock(tb, x, n_heads, dtype, key_mask, comm)
    return x


def forward(params, x, mu, t, spks, cond, mask=None,
            cfg: FlowDecoderConfig = FlowDecoderConfig(), dtype=torch.float32, comm=None):
    """Velocity estimate (channel-last).

      x:    (B, T, 80) noisy mel
      mu:   (B, T, 80) encoder output
      t:    (B,) diffusion time
      spks: (B, 80) speaker embedding
      cond: (B, T, 80) prompt-mel conditioning
      mask: (B, T, 1) or None
      comm: parallel.sp.SeqComm when T is this rank's shard of an sp mesh
        (module docstring).
    Returns (B, T, 80) fp32.
    """
    return forward_mid_cached(params, x, mu, t, spks, cond, mask, cfg, dtype, comm=comm)[0]


def forward_mid_cached(params, x, mu, t, spks, cond, mask=None,
                       cfg: FlowDecoderConfig = FlowDecoderConfig(),
                       dtype=torch.float32, mid_feats=None, reuse_mid=False, comm=None):
    """`forward` that also returns the mid stack's output, for DeepCache
    solver steps (cfm.solve_euler with cache_every): with `reuse_mid` the
    downsample conv and the mid stages are skipped and `mid_feats` (the
    output of an earlier step) takes their place; the down stage still
    runs, since its output is the up stage's skip input. `comm`: forward's
    (the solver runs no DeepCache step under it).

    Returns (velocity (B, T, 80) fp32, mid_feats): on a fresh call the new
    mid output in `dtype`, on a reuse call the one passed in."""
    b, tlen, _ = x.shape
    key_mask = None
    if mask is None:
        mask = torch.ones((b, tlen, 1), dtype=x.dtype, device=x.device)
    else:
        # bucket-padding exactness: pad positions must not be attended to
        km = mask if comm is None else comm.gather(mask)
        key_mask = (km[..., 0] > 0)[:, None, None, :]        # (B, 1, 1, T_full)
    t_emb = _sinusoidal_t(t, cfg.in_channels)
    t_emb = L.linear(params["time_mlp"]["lin2"],
                     F.silu(L.linear(params["time_mlp"]["lin1"], t_emb)))

    h = torch.cat([x, mu, spks[:, None, :].expand(b, tlen, spks.shape[-1]), cond],
                  dim=-1).to(dtype)

    h = _stage(params["down"], h, mask, t_emb, cfg.num_heads, dtype, key_mask, comm)
    skip = h
    if reuse_mid:
        h = mid_feats
    else:
        h = _causal_conv3(params["down"]["downsample"], h * mask, dtype, comm)
        for st in params["mid"]:
            h = _stage(st, h, mask, t_emb, cfg.num_heads, dtype, key_mask, comm)
        # the carried cache stays in `dtype` whatever the stage math
        # promoted to (a float32 mask upcasts h under bf16 compute)
        mid_feats = h.to(dtype)

    h = torch.cat([h, skip], dim=-1)
    h = _stage(params["up"], h, mask, t_emb, cfg.num_heads, dtype, key_mask, comm)
    h = _causal_conv3(params["up"]["upsample"], h * mask, dtype, comm)

    h = _causal_block(params["final_block"], h, mask, dtype, comm)
    out = L.conv1d(params["final_proj"], h * mask, dtype=dtype)
    return (out * mask).float(), mid_feats
