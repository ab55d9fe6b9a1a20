"""Rel-pos attention of the batched conformer: the Hopper port of the Pallas
TPU kernel `chatterbox_embed_tpu/kernels/rel_attention.py`.

The Transformer-XL score ac + bd of the conformer is factored into one
augmented product (`models/conformer.py:_rel_attention` builds the operands,
the JAX package's docstring derives the identity):

    q_aug = [q + u | A | B],  k_aug = [k | cos | sin]
    out   = masked softmax((q_aug . k_aug^T) * scale) . v

`rel_attention` takes q_aug, k_aug (B, T, H, Da) and v (B, T, H, 64) with a
(B, T) key-validity mask. Invalid queries attend the valid keys; a row with
no valid key gives 0. On a CUDA tensor it launches the hand-written kernel
of `csrc/rel_attention.cu`: bf16 inputs run on the tensor cores
(`csrc/masked_attention_tc.cuh`, q.k widths up to 576), fp32 inputs on the
CUDA cores (`csrc/masked_attention.cuh`); `masked_attention.plan` states the
tiles of a call. On a CPU tensor it runs `rel_attention_reference`, the
plain PyTorch version. A CUDA call the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .masked_attention import check_width

SOURCE = _build.CSRC / "rel_attention.cu"
VALUE_DIM = 64          # the kernel's compiled value width
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float]
             + [ctypes.c_int, ctypes.c_void_p])


def rel_attention_reference(q_aug, k_aug, v, key_valid, scale: float):
    """Plain PyTorch version, the JAX kernel's body written out: fp32
    scores, invalid keys at -1e30, exp weights zeroed at invalid keys, the
    sum clamped at 1e-30 (so an all-invalid row gives 0), p cast to v's
    dtype for the p.v product. Returns (B, T, H, Dv) in v's dtype."""
    s = torch.einsum("bqhd,bkhd->bhqk", q_aug.float(), k_aug.float()) * scale
    valid = key_valid[:, None, None, :]
    s = s.masked_fill(~valid, -1e30)
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s) * valid
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / den
    return o.transpose(1, 2).to(v.dtype)


def _check(q_aug, k_aug, v, key_valid, scale=1.0):
    if q_aug.device.type != "cuda":
        raise ValueError(f"rel_attention: unsupported device {q_aug.device}")
    for name, x in (("k_aug", k_aug), ("v", v), ("key_valid", key_valid)):
        if x.device != q_aug.device:
            raise ValueError(f"rel_attention: {name} on {x.device}, q_aug on {q_aug.device}")
    if q_aug.dtype not in _DTYPE_CODE:
        raise ValueError(f"rel_attention: dtype {q_aug.dtype} not supported (float32, bfloat16)")
    if k_aug.dtype != q_aug.dtype or v.dtype != q_aug.dtype:
        raise ValueError(f"rel_attention: dtypes differ: q_aug {q_aug.dtype}, "
                         f"k_aug {k_aug.dtype}, v {v.dtype}")
    if key_valid.dtype != torch.bool:
        raise ValueError(f"rel_attention: key_valid must be bool, got {key_valid.dtype}")
    if (q_aug.dim() != 4 or k_aug.shape != q_aug.shape or v.dim() != 4
            or v.shape[:3] != q_aug.shape[:3] or key_valid.shape != q_aug.shape[:2]):
        raise ValueError(f"rel_attention: want q_aug, k_aug (B, T, H, Da), v (B, T, H, Dv) "
                         f"and key_valid (B, T); got {tuple(q_aug.shape)}, "
                         f"{tuple(k_aug.shape)}, {tuple(v.shape)}, {tuple(key_valid.shape)}")
    if v.shape[-1] != VALUE_DIM:
        raise ValueError(f"rel_attention: value dim {v.shape[-1]} != {VALUE_DIM}")
    if q_aug.shape[1] < 1:
        raise ValueError("rel_attention: empty sequence")
    check_width(q_aug.shape[-1], q_aug.dtype)
    if q_aug.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError(f"rel_attention: the bf16 kernel takes its row max over the raw "
                         f"scores and needs scale > 0, got {scale}")
    for name, x in (("q_aug", q_aug), ("k_aug", k_aug), ("v", v), ("key_valid", key_valid)):
        if not x.is_contiguous():
            raise ValueError(f"rel_attention: {name} must be contiguous")
    for name, x in (("q_aug", q_aug), ("k_aug", k_aug), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"rel_attention: {name} must start on a 16-byte boundary")


def rel_attention(q_aug, k_aug, v, key_valid, scale: float):
    """Masked softmax((q_aug . k_aug^T) * scale) . v over each row's valid
    keys. q_aug, k_aug (B, T, H, Da); v (B, T, H, Dv); key_valid (B, T)
    bool. Returns (B, T, H, Dv) in v's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in `rel_attention.launches`) or raise."""
    if q_aug.device.type == "cpu":
        return rel_attention_reference(q_aug, k_aug, v, key_valid, scale)
    _check(q_aug, k_aug, v, key_valid, scale)
    b, t, h, da = q_aug.shape
    lib = _build.load(SOURCE, "cbx_rel_attention", _ARGTYPES)
    out = torch.empty_like(v)
    stream = torch.cuda.current_stream(q_aug.device).cuda_stream
    rc = lib.cbx_rel_attention(q_aug.data_ptr(), k_aug.data_ptr(), v.data_ptr(),
                               key_valid.data_ptr(), out.data_ptr(), b, t, h, da,
                               v.shape[-1], float(scale), _DTYPE_CODE[q_aug.dtype],
                               stream)
    if rc != 0:
        raise RuntimeError(f"rel_attention kernel launch failed: cudaError {rc}")
    rel_attention.launches += 1
    return out


rel_attention.launches = 0
