"""Flash-decode attention for the T3 decode step: the Hopper port of the
Pallas TPU kernel `chatterbox_embed_tpu/kernels/flash_decode.py`.

`decode_attention` attends one query token per (row, head) to the live
cache slots [start, cache_pos] of one layer's sequence-major cache, minus an
optional per-row dead range [lo, hi). On a CUDA tensor it launches the
hand-written split-KV kernel in `csrc/flash_decode.cu` (design notes there);
on a CPU tensor it runs `decode_attention_reference`, the plain PyTorch
version. There is no other path: a CUDA call that the kernel cannot take
raises.

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
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def decode_attention_reference(q, k, v, cache_pos, start=0, hole=None):
    """Plain PyTorch version (mirrors the JAX package's
    decode_attention_reference). q (B, H, D); k, v (Lc, B, H, D);
    hole (B, 2) int or None. Returns (B, H, D) in q's dtype."""
    lcache = k.shape[0]
    idx = torch.arange(lcache, device=q.device)
    mask = ((idx <= cache_pos) & (idx >= start))[None, None, :]
    if hole is not None:
        hole = torch.as_tensor(hole, dtype=torch.int32, device=q.device)
        dead = (idx[None, :] >= hole[:, :1]) & (idx[None, :] < hole[:, 1:2])
        mask = mask & ~dead[:, None, :]
    logits = torch.einsum("bhd,kbhd->bhk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(~mask, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhk,kbhd->bhd", w, v.float()).to(q.dtype)


def _library():
    return _build.load(SOURCE, "cbx_flash_decode", _ARGTYPES)


def _check(q, k, v, hole):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"decode_attention: {name} dtype {t.dtype} != q dtype {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"decode_attention: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape or k.shape[1:] != q.shape:
        raise ValueError(f"decode_attention: want q (B, H, D) and k, v (Lc, B, H, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"decode_attention: head dim {q.shape[-1]} != {HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    if hole is not None:
        if (hole.device != q.device or hole.dtype != torch.int32
                or hole.shape != (q.shape[0], 2) or not hole.is_contiguous()):
            raise ValueError("decode_attention: hole must be a contiguous "
                             "(B, 2) int32 tensor on q's device")


def decode_attention(q, k, v, cache_pos, start=0, hole=None):
    """q (B, H, D); k, v (Lc, B, H, D) one layer's cache; attends slots
    [start, cache_pos] minus each row's optional hole [lo, hi) (hole: (B, 2)
    int32). Returns (B, H, D) in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in `decode_attention.launches`) or raise."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, cache_pos, start, hole)
    _check(q, k, v, hole)
    cache_pos, start = int(cache_pos), int(start)
    lcache = k.shape[0]
    if not 0 <= start <= cache_pos < lcache:
        raise ValueError(f"decode_attention: need 0 <= start ({start}) <= "
                         f"cache_pos ({cache_pos}) < Lc ({lcache})")
    b, h, d = q.shape
    n_splits = -(-lcache // SPLIT_LEN)
    lib = _library()
    out = torch.empty_like(q)
    part_m = torch.empty((b * h, n_splits), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b * h, n_splits, d), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.cbx_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if hole is None else hole.data_ptr(), out.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        b, h, d, cache_pos, start, SPLIT_LEN, n_splits, _DTYPE_CODE[q.dtype],
        stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {rc}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
