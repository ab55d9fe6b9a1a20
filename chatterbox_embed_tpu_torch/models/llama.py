"""Llama-520M backbone for T3, the PyTorch counterpart of
`chatterbox_embed_tpu/models/llama.py`.

- static KV cache, sequence-major (layers, L, B, H, D): prefill writes a
  block, each decode step writes one slot in place before it attends
  (insert-first);
- llama3-scaled RoPE from integer position ids (fp32);
- attention logits and softmax in fp32, everything else in the compute dtype;
- single-token decode attends through the flash-decode kernel
  (`kernels.flash_decode.decode_attention`) on `cache.k[i]`, a view of the
  stacked cache, so no per-layer copy is made;
- under CHATTERBOX_DEFER_KV=1 (read at call time, as the JAX package does)
  a decode step defers its cache writes: each layer attends through the
  kernel's deferred-insert entry (the stacked cache with `layer`, the
  current k/v row folded in) and all layers' rows land in one stacked write
  after the loop (the JAX package's flash branch of that path; the port
  has no phased reads, which its kernels would not use: models/t3.py);
- without a cache (the teacher-forced training forward) every layer runs
  plain attention under the given mask, each under torch.utils.checkpoint
  with `remat`. Under a tp mesh it runs this rank's H/tp heads and its
  slice of the MLP through Megatron's pair of collectives (parallel/
  mesh.py): the gradient of each column-parallel input (q/k/v, gate/up) is
  summed over tp (`Mesh.tp_input`), and each row-parallel product (o,
  down) is summed over tp forward with an identity backward
  (`Mesh.sum_tp`). `remat` re-runs a layer's forward in the backward, its
  collectives with it: the recompute starts at the first saved tensor the
  layer's backward reads and stops after the last one it needs (torch's
  early stop), so every tp rank, running the same graph, meets the same
  collectives in the same order;
- the alignment spy (`collect_attn_layer`): at a decode step that one
  layer runs plain attention (a matmul and a softmax, as the JAX package's
  XLA spy path does) and also returns its head-mean probability row over
  cache coordinates; every other layer keeps K1 (K1s under the deferred
  insert);
- under a tp mesh (`mesh`, parallel/mesh.py) the params are this rank's
  Megatron shard: q/k/v/gate/up hold its columns, so each rank attends
  its H/tp heads (counted from the shard's width) and K1 walks them
  unchanged; o/down hold its rows, and their products are summed over tp
  before the residual add (the psum GSPMD inserts in the JAX package). The
  spy's head mean is each rank's partial mean, weighted (H/tp)/H and
  summed over tp;
- the int8 KV cache (CHATTERBOX_INT8_KV=1, the JAX package's mode 1): k/v
  int8 with one fp32 scale a (slot, row, head), amax / 127 + 1e-12, the
  values rounded half to even. Every write quantises (the block write of a
  prefill or an insert-first step, the deferred stacked write after the
  loop, whose current row each layer folds in unquantised); a decode layer
  reads it through K1's or K1s's int8 entry, the spy layer by the JAX
  package's formula with both scales factored out of the dots, and a
  multi-token forward over the cache dequantises k/v x scale in the
  compute dtype. Mode 2 (int8 x int8 dots) is not ported yet: ROADMAP
  queue 1 names it as the next slice.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import LlamaConfig
from ..device import constant, resolve_device
from ..kernels.flash_decode import decode_attention
from . import layers as L


class KVCache(NamedTuple):
    """(layers, L, B, H, D) k and v, updated in place by `forward`; for an
    int8 cache also their (layers, L, B, H) fp32 scales (None otherwise)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None


def init(init: L.Init, cfg: LlamaConfig = LlamaConfig()):
    d = cfg.hidden_size
    kv_out = cfg.num_kv_heads * cfg.head_dim
    q_out = cfg.num_heads * cfg.head_dim
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": {"scale": init.ones((d,))},
            "q": L.linear_init(init, d, q_out, bias=False),
            "k": L.linear_init(init, d, kv_out, bias=False),
            "v": L.linear_init(init, d, kv_out, bias=False),
            "o": L.linear_init(init, q_out, d, bias=False),
            "ln2": {"scale": init.ones((d,))},
            "gate": L.linear_init(init, d, cfg.intermediate_size, bias=False),
            "up": L.linear_init(init, d, cfg.intermediate_size, bias=False),
            "down": L.linear_init(init, cfg.intermediate_size, d, bias=False),
        })
    return {"layers": layers, "norm": {"scale": init.ones((d,))}}


# ---------------------------------------------------------------------------
# RoPE (llama3 scaling)
# ---------------------------------------------------------------------------

def _scaled_inv_freq(cfg: LlamaConfig) -> np.ndarray:
    """Computed in float64, then cast to float32 (as the JAX package does)."""
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, cfg.head_dim, 2, np.float64) / cfg.head_dim))
    wavelen = 2.0 * np.pi / inv
    low_wl = cfg.rope_original_max_position / cfg.rope_low_freq_factor
    high_wl = cfg.rope_original_max_position / cfg.rope_high_freq_factor
    smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
    scaled = np.where(wavelen > low_wl, inv / cfg.rope_scaling_factor,
                      np.where(wavelen < high_wl, inv,
                               (1 - smooth) * inv / cfg.rope_scaling_factor + smooth * inv))
    return scaled.astype(np.float32)


def inv_freq(cfg: LlamaConfig, device) -> torch.Tensor:
    """The scaled inverse frequencies (head_dim / 2,) fp32 on `device`,
    copied there once per (RoPE settings, device): a copy from the host is
    not allowed inside a CUDA graph capture."""
    key = ("inv_freq", cfg.head_dim, cfg.rope_theta, cfg.rope_scaling_factor,
           cfg.rope_low_freq_factor, cfg.rope_high_freq_factor, cfg.rope_original_max_position)
    return constant(key, device, lambda: _scaled_inv_freq(cfg))


def rope_cos_sin(pos_ids: torch.Tensor, cfg: LlamaConfig):
    """pos_ids (B, T) int -> cos, sin (B, T, head_dim) fp32."""
    inv = inv_freq(cfg, pos_ids.device)
    ang = pos_ids[..., None].float() * inv                      # (B, T, D/2)
    ang = torch.cat([ang, ang], dim=-1)                          # HF half-split layout
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, T, H, D); HF rotate-half convention."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * cos[:, :, None, :]
            + rotated.float() * sin[:, :, None, :]).to(x.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _kv_int8_mode() -> int:
    """CHATTERBOX_INT8_KV, read at call time where the JAX package reads
    it (each generation's and engine's cache): unset or 0 is the
    compute-dtype cache, 1 the int8 cache. 2, the JAX package's int8 x int8
    dots, raises: it is not ported yet (ROADMAP queue 1, the next slice).
    On a GPU the default is 0 (the JAX default of 1 is a TPU's)."""
    env = os.getenv("CHATTERBOX_INT8_KV")
    if env is None or env.strip() == "0":
        return 0
    if env.strip() == "1":
        return 1
    if env.strip() == "2":
        raise NotImplementedError(
            "CHATTERBOX_INT8_KV=2: int8 x int8 decode dots are not ported yet (ROADMAP "
            "queue 1, the next slice); set 1 or 0")
    raise ValueError(f"CHATTERBOX_INT8_KV={env!r}: want 0, 1 or 2")


def kv_heads(params, cfg: LlamaConfig) -> int:
    """K/V heads of a backbone's params: cfg.num_kv_heads, or this rank's
    share of them for a tp shard (the k projection's width)."""
    k = params["layers"][0]["k"]
    return k["w_q" if "w_q" in k else "w"].shape[1] // cfg.head_dim


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.float32,
               device=None, heads: Optional[int] = None) -> KVCache:
    """Zero (layers, max_len, batch, heads, D) k and v; heads defaults to
    cfg.num_kv_heads (a tp rank passes its share, `kv_heads`). dtype
    torch.int8 makes the int8 cache, with zero (layers, max_len, batch,
    heads) fp32 scale planes."""
    device = resolve_device(device)
    shape = (cfg.num_layers, max_len, batch, heads or cfg.num_kv_heads, cfg.head_dim)
    scales = ()
    if dtype == torch.int8:
        scales = tuple(torch.zeros(shape[:-1], dtype=torch.float32, device=device)
                       for _ in range(2))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), *scales)


def quantize_kv(x: torch.Tensor):
    """Rows (..., D) -> (int8 rows, fp32 scales (...)): scale = amax / 127 +
    1e-12 over the row, int8 = round(x / scale) half to even (the JAX
    package's int8 cache writes)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0 + 1e-12
    return torch.round(xf / s[..., None]).to(torch.int8), s


def _write(cache: KVCache, idx, k_rows, v_rows) -> None:
    """cache.k[idx] = k_rows and cache.v[idx] = v_rows, quantised (with
    their scales) into an int8 cache."""
    if cache.k_scale is None:
        cache.k[idx] = k_rows.to(cache.k.dtype)
        cache.v[idx] = v_rows.to(cache.v.dtype)
        return
    for slab, plane, rows in ((cache.k, cache.k_scale, k_rows),
                              (cache.v, cache.v_scale, v_rows)):
        q, s = quantize_kv(rows)
        slab[idx] = q
        plane[idx] = s


def _read(cache: KVCache, i: int, dtype):
    """Layer i's k and v as (B, L, H, D) in `dtype`; an int8 cache's
    dequantised, x scale in the compute dtype."""
    k, v = cache.k[i].transpose(0, 1).to(dtype), cache.v[i].transpose(0, 1).to(dtype)
    if cache.k_scale is not None:
        k = k * cache.k_scale[i].transpose(0, 1)[..., None].to(dtype)
        v = v * cache.v_scale[i].transpose(0, 1)[..., None].to(dtype)
    return k, v


def _defer_kv_enabled() -> bool:
    """CHATTERBOX_DEFER_KV=1: the deferred stacked KV insert of the decode
    step (the JAX package's llama._defer_kv_enabled)."""
    return os.getenv("CHATTERBOX_DEFER_KV", "") == "1"


def _qkv(lp, h, cos, sin, cfg: LlamaConfig, dtype, mesh=None):
    """A layer's RMSNorm and q, k, v projections, RoPE on q and k; the
    heads are as many as the projections' widths hold (all of them, or a
    tp rank's share)."""
    hin = _tp_input(L.rms_norm(lp["ln1"], h, cfg.rms_norm_eps), mesh)
    q, k, v = (L.linear(lp[n], hin, dtype) for n in ("q", "k", "v"))
    q, k, v = (L.split_heads(x, x.shape[-1] // cfg.head_dim) for x in (q, k, v))
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _sum_tp(y, mesh):
    """A row-parallel product summed over the mesh's tp ranks."""
    return y if mesh is None else mesh.sum_tp(y)


def _tp_input(x, mesh):
    """A column-parallel product's input: its gradient is summed over the
    mesh's tp ranks under autograd (nothing moves forward)."""
    return x if mesh is None else mesh.tp_input(x)


def _mlp(lp, h, cfg: LlamaConfig, dtype, mesh=None):
    """A layer's second half: RMSNorm, SwiGLU MLP, residual."""
    hin = _tp_input(L.rms_norm(lp["ln2"], h, cfg.rms_norm_eps), mesh)
    return h + _sum_tp(L.linear(lp["down"], F.silu(L.linear(lp["gate"], hin, dtype))
                                * L.linear(lp["up"], hin, dtype), dtype), mesh)


def _layer(lp, h, cos, sin, mask4, cfg: LlamaConfig, dtype, mesh=None):
    """One layer over a whole block without a cache (plain attention); on a
    tp mesh, this rank's heads and MLP slice."""
    q, k, v = _qkv(lp, h, cos, sin, cfg, dtype, mesh)
    h = h + _sum_tp(L.linear(lp["o"], L.merge_heads(L.mha(q, k, v, mask=mask4)), dtype), mesh)
    return _mlp(lp, h, cfg, dtype, mesh)


def forward(params, x: torch.Tensor, pos_ids: torch.Tensor,
            attn_mask: Optional[torch.Tensor] = None,
            cache: Optional[KVCache] = None, cache_pos: int = 0,
            cfg: LlamaConfig = LlamaConfig(), dtype=torch.float32,
            flash_start=0, flash_hole: Optional[torch.Tensor] = None,
            collect_attn_layer: Optional[int] = None,
            flash_span: Optional[torch.Tensor] = None, remat: bool = False, mesh=None):
    """Run the transformer over a block of embeddings.

    Args:
      x: (B, T, D) input embeddings.
      pos_ids: (B, T) RoPE positions.
      attn_mask: bool (B|1, T, L) where L is the cache length (or T when no
        cache): True = attend. Defaults to causal. Unused at T == 1 with a
        cache: the decode step attends slots [flash_start, cache_pos]
        through the flash-decode kernel (flash_start an int or a
        one-element int32 tensor on the device), minus each row's dead range
        [lo, hi) of `flash_hole` ((B, 2) int32, or None); with `flash_span`
        ((B, 2) int32) row b attends [span[b, 0], span[b, 1]] minus its hole
        instead (the K/V insert stays at the shared cache_pos).
      cache: optional static KVCache; the block's K/V are written in place
        at [cache_pos, cache_pos + T) before attention, or, for a decode step
        under CHATTERBOX_DEFER_KV=1, for every layer at once after the loop.
      collect_attn_layer: at a decode step, the layer whose attention runs
        plain (`_spy_attention`) and whose head-mean probability row over
        the cache is returned as well (the alignment spy).
      remat: without a cache (the training forward), run each layer under
        torch.utils.checkpoint (use_reentrant=False): its activations are
        recomputed in the backward instead of kept. The gradients are equal.
      mesh: a mesh whose tp ranks hold the params' Megatron shards (module
        docstring), with a cache or without one; None or tp 1 computes
        alone.
    Returns (hidden (B, T, D) after the final norm, cache[, attn_row (B, Lc)
    fp32]).
    """
    b, t, _ = x.shape
    h = x.to(dtype)
    tp = mesh if mesh is not None and mesh.tp > 1 else None
    cos, sin = rope_cos_sin(pos_ids, cfg)
    decode = t == 1 and cache is not None
    defer = decode and _defer_kv_enabled() and flash_span is None
    new_ks, new_vs = [], []
    if collect_attn_layer is not None and not decode:
        raise ValueError("collect_attn_layer needs a single-token decode step with a cache")
    if flash_span is not None and (not decode or collect_attn_layer is not None):
        raise ValueError("flash_span needs a single-token decode step with a cache and "
                         "no alignment spy")
    attn_row = None

    if attn_mask is None and not decode:
        if cache is None:
            attn_mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()[None]
        else:
            idx = torch.arange(cache.k.shape[1], device=x.device)[None, :]
            q_idx = cache_pos + torch.arange(t, device=x.device)[:, None]
            attn_mask = (idx <= q_idx)[None]                     # (1, T, L)
    mask4 = None if decode else attn_mask[:, None]

    if cache is None:
        for lp in params["layers"]:
            if remat:
                h = checkpoint(_layer, lp, h, cos, sin, mask4, cfg, dtype, tp,
                               use_reentrant=False)
            else:
                h = _layer(lp, h, cos, sin, mask4, cfg, dtype, tp)
        return L.rms_norm(params["norm"], h, cfg.rms_norm_eps), None

    int8 = cache.k_scale is not None
    for i, lp in enumerate(params["layers"]):
        q, k, v = _qkv(lp, h, cos, sin, cfg, dtype)
        scales = (dict(k_scale=cache.k_scale[i], v_scale=cache.v_scale[i]) if int8
                  else {})

        if not defer:
            # insert-first, in place: slots [cache_pos, cache_pos + T) of
            # layer i take this block's rows (quantised into an int8 cache)
            _write(cache, (i, slice(cache_pos, cache_pos + t)), k.transpose(0, 1),
                   v.transpose(0, 1))
        if defer:
            # the current row joins the softmax as one more key, in the
            # compute dtype; slot cache_pos is written for every layer after
            # the loop
            k_cur = k[:, 0].to(dtype if int8 else cache.k.dtype).contiguous()
            v_cur = v[:, 0].to(dtype if int8 else cache.v.dtype).contiguous()
            new_ks.append(k_cur)
            new_vs.append(v_cur)
        if decode and i == collect_attn_layer:
            att, attn_row = _spy_attention(
                q[:, 0], cache.k[i], cache.v[i], cache_pos, flash_start, flash_hole,
                k_cur if defer else None, v_cur if defer else None, **scales)
            att = att[:, None]
            if tp is not None:
                attn_row = tp.sum_tp(attn_row * (q.shape[2] / cfg.num_heads))
        elif defer:
            stacked = dict(k_scale=cache.k_scale, v_scale=cache.v_scale) if int8 else {}
            att = decode_attention(q[:, 0].contiguous(), cache.k, cache.v, cache_pos,
                                   start=flash_start, hole=flash_hole, layer=i,
                                   k_cur=k_cur, v_cur=v_cur, **stacked)[:, None]
        elif decode:
            att = decode_attention(q[:, 0], cache.k[i], cache.v[i], cache_pos,
                                   start=flash_start, hole=flash_hole,
                                   span=flash_span, **scales)[:, None]
        else:
            k_att, v_att = _read(cache, i, dtype)                # (B, L, H, D)
            att = L.mha(q, k_att, v_att, mask=mask4)
        h = h + _sum_tp(L.linear(lp["o"], L.merge_heads(att), dtype), tp)
        h = _mlp(lp, h, cfg, dtype, tp)

    if defer:
        # one stacked write of all layers' rows at slot cache_pos
        _write(cache, (slice(None), cache_pos), torch.stack(new_ks), torch.stack(new_vs))
    h = L.rms_norm(params["norm"], h, cfg.rms_norm_eps)
    if collect_attn_layer is not None:
        return h, cache, attn_row
    return h, cache


def _spy_attention(q, k, v, cache_pos: int, start: int, hole, k_cur=None, v_cur=None,
                   k_scale=None, v_scale=None):
    """The alignment spy layer's decode attention, plain: q (B, H, D) over
    one layer's cache k, v (Lc, B, H, D), slots [start, cache_pos] minus
    each row's hole [lo, hi), logits and softmax in fp32 (the JAX package's
    XLA decode attention). With k_cur/v_cur (the deferred insert) the slots
    end at cache_pos - 1 and the current row is one more key, whose
    probability is folded back into slot cache_pos of the row, as the JAX
    package's `_spy_row` does. Only the live prefix [0, cache_pos] is read.
    An int8 cache's (Lc, B, H) scales factor out of both dots as in the JAX
    package (llama.py:418-440): logits (q . kq) * ks / sqrt(D), then
    (w * vs) in q's dtype times vq.

    Returns (att (B, H, D) in q's dtype, head-mean probabilities (B, Lc)
    fp32 over cache coordinates)."""
    lc = k.shape[0]
    n = cache_pos + 1
    dev = q.device
    kidx = torch.arange(n, device=dev)
    end = cache_pos - 1 if k_cur is not None else cache_pos
    valid = ((kidx >= start) & (kidx <= end))[None].expand(q.shape[0], n)
    if hole is not None:
        hole = hole.to(dev).long()
        valid = valid & ~((kidx[None] >= hole[:, :1]) & (kidx[None] < hole[:, 1:]))
    scale = float(np.sqrt(q.shape[-1]))
    logits = torch.einsum("bhd,lbhd->bhl", q.float(), k[:n].float())
    if k_scale is not None:
        logits = logits * k_scale[:n].permute(1, 2, 0)
    logits = logits / scale
    logits = torch.where(valid[:, None, :], logits,
                         torch.tensor(-1e10, dtype=torch.float32, device=dev))
    if k_cur is not None:
        lcur = (q.float() * k_cur.float()).sum(-1, keepdim=True) / scale   # (B, H, 1)
        logits = torch.cat([logits, lcur], dim=-1)
    w = torch.softmax(logits, dim=-1)
    row = torch.zeros((q.shape[0], lc), dtype=torch.float32, device=dev)
    row[:, :n] = w[..., :n].mean(dim=1)
    wl = w[..., :n]
    if v_scale is not None:
        wl = wl * v_scale[:n].permute(1, 2, 0)
    cdt = q.dtype if v_scale is not None else v.dtype
    att = torch.einsum("bhl,lbhd->bhd", wl.to(cdt), v[:n].to(cdt))
    if k_cur is not None:
        row[:, cache_pos] += w[..., n].mean(dim=1)
        att = (att.float() + w[..., n:] * v_cur.float()).to(cdt)
    return att.to(q.dtype), row
