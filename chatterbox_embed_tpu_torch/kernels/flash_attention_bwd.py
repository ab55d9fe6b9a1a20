"""The backward of the key-masked self-attention K3 (K3b): the Hopper port
of the stock Pallas TPU flash attention's two backward kernels
(`_flash_attention_bwd_dq` and `_flash_attention_bwd_dkv`), which the JAX
package's `models/layers.py:mha_flash` would reach under `jax.grad`.

`flash_attention_backward(q, k, v, key_valid, out, dout, lse)` returns
(dq, dk, dv) of `flash_attention.flash_attention` at its output `out`, for
the upstream gradient `dout`, from the lse that K3's forward saved (as the
stock op's backward takes the l and m its forward saved). On a CUDA tensor
it launches the two hand-written kernels of `csrc/flash_attention_bwd.cu`
(K3b-dq, then K3b-dkv, which reads the di that K3b-dq writes; bf16 on the
tensor cores, fp32 on the CUDA cores); on a CPU tensor it runs
`flash_attention_backward_reference`, the kernels' function in plain
PyTorch (`reference_dq`, then `reference_dkv`: one for each kernel). A CUDA
call the kernels cannot take raises. A row with no valid key (lse +inf)
gets zero gradients, as K3 writes 0 there.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import _DTYPE_CODE, _check, lse_reference
from .masked_attention import round_operand

SOURCE = _build.CSRC / "flash_attention_bwd.cu"
# both C entries take the same arguments: q, k, v, key_valid, out, dout,
# lse, di, dq, dk, dv, then batch, seq, heads, head_dim, dtype, and the stream
_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def reference_dq(q, k, v, key_valid, out, dout, lse):
    """Plain PyTorch version of K3b-dq, in fp32, from K3's lse (B, H, T):
    P = exp(s - lse) over the valid keys, di = rowsum(dO . O), then
    dq = scale . dS k with dS = P (dO v^T - di), dS rounded to q's dtype
    as the product's operand (as the TPU kernel rounds it). q, k, v, out,
    dout (B, T, H, D); key_valid (B, T) bool. Returns (dq in q's dtype,
    di), di (B, H, T) fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, of, gf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, out, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(key_valid[:, None, None, :], torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    di = (gf * of).sum(dim=-1)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - di[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", round_operand(ds, q.dtype), kf) * scale
    return dq.permute(0, 2, 1, 3).to(q.dtype), di


def reference_dkv(q, k, v, key_valid, dout, lse, di):
    """Plain PyTorch version of K3b-dkv, in fp32, from K3's lse and
    `reference_dq`'s di (both (B, H, T)): P = exp(s - lse) over the valid
    keys, dv = P^T dO and dk = scale . dS^T q, P and dS rounded to the
    inputs' dtype as the products' operands (as the TPU kernel rounds them).
    Returns (dk, dv) in the dtypes of k and v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, gf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, dout))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    p = torch.where(key_valid[:, None, None, :], torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf) - di[..., None])
    dk = torch.einsum("bhqk,bhqd->bhkd", round_operand(ds, q.dtype), qf) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", round_operand(p, q.dtype), gf)
    return dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


def flash_attention_backward_reference(q, k, v, key_valid, out, dout, lse=None):
    """Plain PyTorch version of K3b: `reference_dq`, then `reference_dkv` on
    its di, from K3's lse or, without one, the plain lse
    (`flash_attention.lse_reference`). Returns (dq, dk, dv) in the dtypes of
    q, k and v."""
    if lse is None:
        lse = lse_reference(q, k, key_valid)
    dq, di = reference_dq(q, k, v, key_valid, out, dout, lse)
    return (dq, *reference_dkv(q, k, v, key_valid, dout, lse, di))


def flash_attention_backward(q, k, v, key_valid, out, dout, lse):
    """(dq, dk, dv) of K3 at (q, k, v, key_valid) with output `out`, lse
    `lse` (K3's, (B, H, T) fp32) and upstream gradient `dout`, all (B, T,
    H, D) but key_valid (B, T) bool.

    CPU tensors take the plain version; CUDA tensors launch K3b-dq and
    K3b-dkv (each launch counted, in `flash_attention_backward.launches_dq`
    and `.launches_dkv`) or raise."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, key_valid, out, dout, lse)
    _check(q, k, v, key_valid)
    for name, x in (("out", out), ("dout", dout)):
        if x.device != q.device or x.dtype != q.dtype or x.shape != q.shape:
            raise ValueError(f"flash_attention_backward: {name} is {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}; q is {q.dtype} {tuple(q.shape)} on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_backward: {name} must be contiguous")
    b, t, h, d = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32 or lse.shape != (b, h, t)
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_backward: lse is {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}; want contiguous float32 {(b, h, t)} on {q.device}")
    entries = {entry: getattr(_build.load(SOURCE, entry, _ARGTYPES), entry)
               for entry in ("cbx_flash_attention_bwd_dq", "cbx_flash_attention_bwd_dkv")}
    di = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [x.data_ptr() for x in (q, k, v, key_valid, out, dout, lse, di, dq, dk, dv)]
    dims = (b, t, h, d, _DTYPE_CODE[q.dtype], stream)
    for entry, counter in (("cbx_flash_attention_bwd_dq", "launches_dq"),
                           ("cbx_flash_attention_bwd_dkv", "launches_dkv")):
        rc = entries[entry](*ptrs, *dims)
        if rc != 0:
            raise RuntimeError(f"flash_attention_backward: {entry} launch failed: "
                               f"cudaError {rc}")
        setattr(flash_attention_backward, counter,
                getattr(flash_attention_backward, counter) + 1)
    return dq, dk, dv


flash_attention_backward.launches_dq = 0
flash_attention_backward.launches_dkv = 0
