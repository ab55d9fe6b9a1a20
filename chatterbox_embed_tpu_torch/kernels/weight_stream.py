"""Weight-stream probe kernel (K5): the Hopper port of the Pallas TPU kernel
in `scripts/microbench_weight_stream.py` (`stream_once`).

`stream_once(x, w, nbuf)` walks a wall of weights `w (n_chunks, R, 1024)`
(bf16 or int8) slab by slab through an `nbuf`-deep ring in shared memory
and multiplies every row with the 8 activation rows `x (8, 1024)`; the
result is `(8, 128)` fp32, `out[i, c]` being the sum of `x[i] . w_flat[g]`
over all wall rows `g` with `g % 128 == c`. It launches the hand-written
kernel in `csrc/weight_stream.cu` (design notes there) and nothing else: a
tensor that is not on a CUDA device, or a shape the kernel does not take,
raises. `stream_once_reference` is the plain PyTorch version, used by the
tests and by the card's check of the kernel, never as a fallback.

`make_wall` fills a wall on the device from the integer formula of the TPU
script's `_make_w`, so both packages stream the same values.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCE = _build.CSRC / "weight_stream.cu"
D = 1024               # the wall's row width (the T3 backbone's hidden size)
ROWS_X = 8             # activation rows (the decode rows, padded to 8)
GROUPS = 128           # output column groups
BLOCKS = 128           # the grid: each block streams rows / BLOCKS rows of a slab
ROWS_PER_BLOCK = (4, 8, 16)     # the kernel's compiled stage heights
_DTYPE_CODE = {torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def make_wall(n_chunks: int, rows: int, dtype, device) -> torch.Tensor:
    """(n_chunks, rows, 1024) wall: v = ((col * 40503 + row * 9973) & 255) - 128
    over the flat row index; int8 keeps v, bf16 holds v / 128."""
    n = n_chunks * rows
    col = torch.arange(D, dtype=torch.int32, device=device)[None, :]
    out = torch.empty((n, D), dtype=dtype, device=device)
    step = 1 << 16                    # bounded scratch for a 1 GB wall
    for r0 in range(0, n, step):
        row = torch.arange(r0, min(n, r0 + step), dtype=torch.int32, device=device)[:, None]
        v = ((col * 40503 + row * 9973) & 255) - 128
        out[r0:r0 + step] = v.to(dtype) if dtype == torch.int8 else (v.float() / 128.0).to(dtype)
    return out.reshape(n_chunks, rows, D)


def stream_once_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: y = x . w_flat^T in fp32 (bf16 wall) or exact
    integers (int8 wall, x truncated to int8 as the kernel does), summed into
    the 128 column groups slab by slab as the TPU kernel does. (8, 128) fp32."""
    n_chunks, rows, d = w.shape
    if w.dtype == torch.int8:
        xa = x.float().trunc().clamp(-128, 127).double()
        y = xa @ w.reshape(-1, d).double().T                    # exact integers
    else:
        y = x.float() @ w.reshape(-1, d).float().T              # (8, n_chunks * R)
    return y.reshape(ROWS_X, n_chunks * rows // GROUPS, GROUPS).sum(dim=1).float()


def _library():
    return _build.load(SOURCE, "cbx_weight_stream", _ARGTYPES)


def stream_once(x: torch.Tensor, w: torch.Tensor, nbuf: int) -> torch.Tensor:
    """x (8, 1024) bf16; w (n_chunks, R, 1024) bf16 or int8 on the same CUDA
    device, contiguous; 2 <= nbuf <= 8; R / BLOCKS in ROWS_PER_BLOCK.
    Returns (8, 128) fp32. Launches the kernel or raises; a launch adds one
    to `stream_once.launches`."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"stream_once: the kernel needs CUDA tensors on one device "
                         f"(x on {x.device}, w on {w.device}); it has no other path")
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (ROWS_X, D) or not x.is_contiguous():
        raise ValueError(f"stream_once: want contiguous bf16 x ({ROWS_X}, {D}); got "
                         f"{x.dtype} {tuple(x.shape)}")
    if w.dtype not in _DTYPE_CODE or w.dim() != 3 or w.shape[2] != D or not w.is_contiguous():
        raise ValueError(f"stream_once: want a contiguous bf16 or int8 wall (n_chunks, R, {D}); "
                         f"got {w.dtype} {tuple(w.shape)}")
    n_chunks, rows, _ = w.shape
    if rows % GROUPS or rows % BLOCKS or rows // BLOCKS not in ROWS_PER_BLOCK:
        raise ValueError(f"stream_once: R={rows} must be a multiple of {GROUPS} and of the "
                         f"grid's {BLOCKS} blocks, with R / {BLOCKS} in {ROWS_PER_BLOCK}")
    if not 2 <= int(nbuf) <= 8:
        raise ValueError(f"stream_once: nbuf={nbuf} outside [2, 8]")
    lib = _library()
    partial = torch.empty((rows, ROWS_X), dtype=torch.float32, device=x.device)
    out = torch.empty((ROWS_X, GROUPS), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.cbx_weight_stream(x.data_ptr(), w.data_ptr(), partial.data_ptr(), out.data_ptr(),
                               n_chunks, rows, D, int(nbuf), BLOCKS,
                               _DTYPE_CODE[w.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"weight_stream kernel launch failed: cudaError {rc} "
                           f"(rows/block {rows // BLOCKS}, nbuf {nbuf})")
    stream_once.launches += 1
    return out


stream_once.launches = 0
