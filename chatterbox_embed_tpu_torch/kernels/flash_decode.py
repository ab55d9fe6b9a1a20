"""Flash-decode attention for the T3 decode step: the Hopper port of the
Pallas TPU kernel `chatterbox_embed_tpu/kernels/flash_decode.py`, both of its
entries.

`decode_attention` attends one query token per (row, head) to the live
cache slots [start, cache_pos] of one layer's sequence-major cache, minus an
optional per-row dead range [lo, hi) (K1). Its second entry (K1s, the
deferred insert) takes the whole stacked cache (nL, Lc, B, H, D) with a
`layer` index and the current token's `k_cur`/`v_cur`: the walk then covers
[start, cache_pos - 1] and the current row finishes the softmax, so the
caller writes every layer's row in one stacked insert after the layer loop.
On a CUDA tensor it launches the hand-written split-KV kernel in
`csrc/flash_decode.cu` (design notes there); on a CPU tensor it runs
`decode_attention_reference`, the plain PyTorch version. There is no other
path: a CUDA call that the kernel cannot take raises.

The kernel is compiled with `nvcc` for sm_90a into a shared library with a
plain C entry, loaded with ctypes, the first time a CUDA tensor arrives
(`kernels/_build.py`, the build route of every kernel of the port).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

SOURCE = _build.CSRC / "flash_decode.cu"
HEAD_DIM = 64          # the kernel's compiled head width
# cache slots per pass-1 block: 32 measured best of {8, 16, 32, 64, 128}
# at the decode shapes on an H100 (PERF.md, Findings)
SPLIT_LEN = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def _layer_slab(k, v, layer):
    """One layer's (Lc, B, H, D) view of a per-layer or stacked cache."""
    if k.dim() == 5:
        if layer is None:
            raise ValueError("decode_attention: a stacked (nL, Lc, B, H, D) cache needs `layer`")
        return k[layer], v[layer]
    return k, v


def decode_attention_reference(q, k, v, cache_pos, start=0, hole=None, layer=None,
                               k_cur=None, v_cur=None):
    """Plain PyTorch version (mirrors the JAX package's
    decode_attention_reference, and its kernel's deferred-insert entry).
    q (B, H, D); k, v (Lc, B, H, D), or (nL, Lc, B, H, D) with `layer`;
    hole (B, 2) int or None. With k_cur/v_cur (B, H, D) the cache slots
    [start, cache_pos - 1] attend and the current row is one more
    logit/value column. Returns (B, H, D) in q's dtype."""
    k, v = _layer_slab(k, v, layer)
    lcache = k.shape[0]
    last = cache_pos - 1 if k_cur is not None else cache_pos
    idx = torch.arange(lcache, device=q.device)
    mask = ((idx <= last) & (idx >= start))[None, None, :]
    if hole is not None:
        hole = torch.as_tensor(hole, dtype=torch.int32, device=q.device)
        dead = (idx[None, :] >= hole[:, :1]) & (idx[None, :] < hole[:, 1:2])
        mask = mask & ~dead[:, None, :]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bhd,kbhd->bhk", q.float(), k.float()) * scale
    logits = logits.masked_fill(~mask, float("-inf"))
    vals = v.float()
    if k_cur is not None:
        cur = (q.float() * k_cur.float()).sum(-1, keepdim=True) * scale     # (B, H, 1)
        logits = torch.cat([logits, cur], dim=-1)
        vals = torch.cat([vals, v_cur.float()[None]], dim=0)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,kbhd->bhd", w, vals).to(q.dtype)


def _library():
    return _build.load(SOURCE, "cbx_flash_decode", _ARGTYPES)


def _check(q, k, v, hole, k_cur, v_cur):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    pairs = [("k", k), ("v", v)]
    if k_cur is not None:
        pairs += [("k_cur", k_cur), ("v_cur", v_cur)]
    for name, t in pairs:
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} dtype {t.dtype} != q dtype {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if (q.dim() != 3 or k.dim() not in (4, 5) or k.shape != v.shape
            or k.shape[-3:] != q.shape):
        raise ValueError(f"decode_attention: want q (B, H, D) and k, v ([nL,] Lc, B, H, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k_cur is not None and (k_cur.shape != q.shape or v_cur.shape != q.shape):
        raise ValueError(f"decode_attention: k_cur, v_cur must be {tuple(q.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {q.shape[-1]} != {HEAD_DIM}")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    if hole is not None:
        if (hole.device != q.device or hole.dtype != torch.int32
                or hole.shape != (q.shape[0], 2) or not hole.is_contiguous()):
            raise ValueError("decode_attention: hole must be a contiguous "
                             "(B, 2) int32 tensor on q's device")


def decode_attention(q, k, v, cache_pos, start=0, hole=None, layer=None,
                     k_cur=None, v_cur=None):
    """q (B, H, D); k, v (Lc, B, H, D) one layer's cache, or the stacked
    (nL, Lc, B, H, D) cache with `layer`. Attends slots [start, cache_pos]
    minus each row's optional hole [lo, hi) (hole: (B, 2) int32); with
    k_cur/v_cur (B, H, D), slots [start, cache_pos - 1] and then the current
    row (the cache slot cache_pos is not read). Returns (B, H, D) in q's
    dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. A launch adds one to `decode_attention.launches` (K1) or, with
    k_cur/v_cur, to `decode_attention.launches_deferred` (K1s)."""
    if (k_cur is None) != (v_cur is None):
        raise ValueError("decode_attention: give both k_cur and v_cur, or neither")
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, cache_pos, start, hole, layer, k_cur, v_cur)
    _check(q, k, v, hole, k_cur, v_cur)
    cache_pos, start = int(cache_pos), int(start)
    n_layers = k.shape[0] if k.dim() == 5 else 1
    layer = 0 if k.dim() == 4 else int(layer)
    lcache = k.shape[-4]
    if not 0 <= start <= cache_pos < lcache:
        raise ValueError(f"decode_attention: need 0 <= start ({start}) <= "
                         f"cache_pos ({cache_pos}) < Lc ({lcache})")
    if not 0 <= layer < n_layers:
        raise ValueError(f"decode_attention: layer {layer} outside [0, {n_layers})")
    b, h, d = q.shape
    n_splits = -(-lcache // SPLIT_LEN)
    lib = _library()
    out = torch.empty_like(q)
    part_m = torch.empty((b * h, n_splits), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b * h, n_splits, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    deferred = k_cur is not None
    rc = lib.cbx_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if hole is None else hole.data_ptr(),
        k_cur.data_ptr() if deferred else None, v_cur.data_ptr() if deferred else None,
        out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        b, h, d, lcache, layer, cache_pos, start, SPLIT_LEN, n_splits,
        _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    if deferred:
        decode_attention.launches_deferred += 1
    else:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.launches_deferred = 0
