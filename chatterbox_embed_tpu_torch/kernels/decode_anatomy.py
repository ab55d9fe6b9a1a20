"""Decode-anatomy probe kernel (K6): the Hopper port of the Pallas TPU kernel
in `scripts/microbench_decode_anatomy.py` (`attn`), the flash-decode walk in
three variants that split its time into loads and attention math.

`attn(q, k, v, pos, mode)` takes one query row `q (1, F)` and a
sequence-major cache `k, v (Lc, F)`, F = groups * 64 (one group per (row,
head) of the decode step), and returns `(1, F)` in q's dtype. With CHUNK =
64 and n_chunks = pos // 64 + 1:

  full          attention of each group over the slots <= pos;
  load_only     the TPU kernel's `dma_only`: the n_chunks chunks are loaded
                as the walk loads them and no attention math runs; the
                result is the sum over the chunks of row 0 of the k chunk
                plus row 0 of the v chunk;
  compute_only  the attention math on one resident chunk: slot j reads cache
                row j % 64, slots > pos masked. The TPU variant reads a
                scratch buffer that nothing filled, so its output is not
                defined there; this is the port's definition.

It launches the hand-written kernel in `csrc/decode_anatomy.cu`, K1's
one-launch design over the port's decode walk (`csrc/decode_walk.cuh`, K1's
split count and workspace), and nothing else: a tensor
that is not on a CUDA device, or a shape the kernel does not take, raises.
`attn_reference` is the plain PyTorch version, used by the tests and by the
card's check of the kernel, never as a fallback.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import flash_decode as _fd

SOURCE = _build.CSRC / "decode_anatomy.cu"
HEAD_DIM = 64
CHUNK = 64             # the TPU kernel's chunk: the unit of load_only and compute_only
MODES = ("full", "load_only", "compute_only")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def attn_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int,
                   mode: str) -> torch.Tensor:
    """Plain PyTorch version. q (1, F); k, v (Lc, F); returns (1, F) in q's
    dtype, computed in fp32."""
    if mode not in MODES:
        raise ValueError(f"attn: mode {mode!r} not in {MODES}")
    f = q.shape[-1]
    g = f // HEAD_DIM
    n_chunks = int(pos) // CHUNK + 1
    if mode == "load_only":
        rows = torch.arange(n_chunks, device=k.device) * CHUNK
        return (k[rows].float() + v[rows].float()).sum(dim=0, keepdim=True).to(q.dtype)
    if mode == "compute_only":
        idx = torch.arange(n_chunks * CHUNK, device=k.device)
        kk, vv = k[idx % CHUNK], v[idx % CHUNK]
    else:
        idx = torch.arange(k.shape[0], device=k.device)
        kk, vv = k, v
    scale = 1.0 / math.sqrt(HEAD_DIM)
    qg = q.float().reshape(g, HEAD_DIM)
    kg = kk.float().reshape(-1, g, HEAD_DIM)
    logits = torch.einsum("gd,jgd->gj", qg, kg) * scale
    logits = logits.masked_fill((idx > pos)[None, :], float("-inf"))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("gj,jgd->gd", w, vv.float().reshape(-1, g, HEAD_DIM))
    return out.reshape(1, f).to(q.dtype)


def _library():
    return _build.load(SOURCE, "cbx_decode_anatomy", _ARGTYPES)


def attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, mode: str
         ) -> torch.Tensor:
    """q (1, F) and k, v (Lc, F), contiguous fp32 or bf16 CUDA tensors of one
    dtype, F a multiple of 64, 0 <= pos < Lc and the walked chunks inside
    Lc. Launches the kernel or raises; a launch adds one to `attn.launches`
    and to `attn.launches_by_mode[mode]`."""
    if mode not in MODES:
        raise ValueError(f"attn: mode {mode!r} not in {MODES}")
    if q.device.type != "cuda":
        raise ValueError(f"attn: the kernel needs CUDA tensors (q on {q.device}); "
                         f"it has no other path")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or not t.is_contiguous():
            raise ValueError(f"attn: {name} must be contiguous, on q's device, of q's dtype")
    if q.dtype not in _DTYPE_CODE or not q.is_contiguous():
        raise ValueError(f"attn: q must be contiguous float32 or bfloat16, got {q.dtype}")
    if (q.dim() != 2 or q.shape[0] != 1 or k.dim() != 2 or k.shape != v.shape
            or k.shape[1] != q.shape[1] or q.shape[1] % HEAD_DIM):
        raise ValueError(f"attn: want q (1, F), k, v (Lc, F), F % {HEAD_DIM} == 0; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    lcache, f = k.shape
    pos = int(pos)
    if not 0 <= pos < lcache or (pos // CHUNK + 1) * CHUNK > lcache:
        raise ValueError(f"attn: pos {pos} and its chunks must lie inside Lc {lcache}")
    groups = f // HEAD_DIM
    lib = _library()
    out = torch.empty_like(q)
    part, counters = _fd.workspace(q.device, q.dtype, groups, 1, lcache)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.cbx_decode_anatomy(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), part.data_ptr(),
        counters.data_ptr(), groups, HEAD_DIM, lcache, pos, _fd.splits_for(groups, lcache),
        MODES.index(mode), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_anatomy kernel launch failed: cudaError {rc} (mode {mode})")
    attn.launches += 1
    attn.launches_by_mode[mode] += 1
    return out


attn.launches = 0
attn.launches_by_mode = {m: 0 for m in MODES}
