"""Key-masked self-attention of the batched CFM estimator: the Hopper port
of the stock Pallas TPU flash attention behind the JAX package's
`models/layers.py:mha_flash`.

`flash_attention(q, k, v, key_valid)` takes q, k, v (B, T, H, 64) and a
(B, T) key-validity mask and returns softmax(q.k^T / 8) . v over each row's
valid keys, non-causal, without an `ab` bias (its one caller never passes
one). It takes `layers.mha`'s key-mask semantics at every query row, where
the TPU kernel differs at invalid query rows only (see
`csrc/flash_attention.cu`); a row with no valid key gives 0. On a CUDA
tensor it launches the hand-written kernel of `csrc/flash_attention.cu`
(bf16 on the tensor cores, `csrc/masked_attention_tc.cuh`; fp32 on the CUDA
cores, `csrc/masked_attention.cuh`); on a CPU tensor it runs
`flash_attention_reference`, which is `layers.mha` with a key mask. A CUDA
call the kernel cannot take raises.

With grad enabled and an input that requires it, the call goes through a
`torch.autograd.Function` whose forward is the same launch and whose
backward is K3b (`kernels/flash_attention_bwd.py`: two hand-written kernels
on the card, their plain version on the CPU); there the forward also writes
each query row's log-sum-exp (lse, as the stock TPU op saves its residuals
l and m), and it saves q, k, v, key_valid, the output and lse. Every other
call (the serving paths run under `no_grad`) launches the forward alone,
without the lse, and saves nothing. `flash_attention_with_lse` gives both
outside autograd; `lse_reference` is the plain lse.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

SOURCE = _build.CSRC / "flash_attention.cu"
HEAD_DIM = 64           # the kernel's compiled head width
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def flash_attention_reference(q, k, v, key_valid):
    """Plain PyTorch version: `layers.mha` with the key mask (fp32 logits,
    masked keys at -1e10, fp32 softmax). Returns (B, T, H, D) in v's dtype."""
    from ..models.layers import mha      # layers imports this module
    return mha(q, k, v, mask=key_valid[:, None, None, :])


def lse_reference(q, k, key_valid):
    """Plain PyTorch version of K3's lse: each query row's log-sum-exp of
    q.k^T / sqrt(D) over its row's valid keys, in fp32 (B, H, T). A row
    with no valid key gets +inf, so that exp(s - lse) is exactly 0 there for
    every finite score s (K3 writes 0 for such a row, K3b gives it zero
    gradients)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = s.masked_fill(~key_valid[:, None, None, :], -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    return torch.where(torch.isneginf(lse), torch.full_like(lse, math.inf), lse)


def _check(q, k, v, key_valid):
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, x in (("k", k), ("v", v), ("key_valid", key_valid)):
        if x.device != q.device:
            raise ValueError(f"flash_attention: {name} on {x.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported (float32, bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes differ: q {q.dtype}, k {k.dtype}, "
                         f"v {v.dtype}")
    if key_valid.dtype != torch.bool:
        raise ValueError(f"flash_attention: key_valid must be bool, got {key_valid.dtype}")
    if (q.dim() != 4 or k.shape != q.shape or v.shape != q.shape
            or key_valid.shape != q.shape[:2]):
        raise ValueError(f"flash_attention: want q, k, v (B, T, H, D) and key_valid (B, T); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(key_valid.shape)}")
    if q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} != {HEAD_DIM}")
    if q.shape[1] < 1:
        raise ValueError("flash_attention: empty sequence")
    for name, x in (("q", q), ("k", k), ("v", v), ("key_valid", key_valid)):
        if not x.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must start on a 16-byte boundary")


def flash_attention(q, k, v, key_valid):
    """softmax(q.k^T / sqrt(D)) . v over each row's valid keys. q, k, v
    (B, T, H, D); key_valid (B, T) bool. Returns (B, T, H, D) in v's dtype,
    differentiable in q, k and v (through K3b) when grad is enabled.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in `flash_attention.launches`) or raise."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashAttention.apply(q, k, v, key_valid)
    return _forward(q, k, v, key_valid, False)[0]


def flash_attention_with_lse(q, k, v, key_valid):
    """(out, lse) of one K3 call outside autograd: the output as
    `flash_attention` gives it and each query row's log-sum-exp, (B, H, T)
    fp32 (`lse_reference` on the CPU). A CUDA call counts one launch."""
    return _forward(q, k, v, key_valid, True)


class _FlashAttention(torch.autograd.Function):
    """K3 forward (with the lse), K3b backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_valid):
        out, lse = _forward(q, k, v, key_valid, True)
        ctx.save_for_backward(q, k, v, key_valid, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        from .flash_attention_bwd import flash_attention_backward   # it imports this module
        q, k, v, key_valid, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, key_valid, out, dout.contiguous(), lse)
        return dq, dk, dv, None


def _forward(q, k, v, key_valid, with_lse: bool):
    """One K3 launch (or the plain version on the CPU), outside autograd:
    (out, lse), lse None unless asked for."""
    if q.device.type == "cpu":
        lse = lse_reference(q, k, key_valid) if with_lse else None
        return flash_attention_reference(q, k, v, key_valid), lse
    _check(q, k, v, key_valid)
    b, t, h, d = q.shape
    lib = _build.load(SOURCE, "cbx_flash_attention", _ARGTYPES)
    out = torch.empty_like(v)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.cbx_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 key_valid.data_ptr(), out.data_ptr(),
                                 None if lse is None else lse.data_ptr(), b, t, h, d,
                                 _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
