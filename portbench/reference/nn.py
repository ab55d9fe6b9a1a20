"""Plain PyTorch building blocks of the benchmark's reference: fp32 with
TF32 off, no kernels, no cache, no batching.

Parameters are nested dicts in the port's tree layout (the benchmark hands
the same values to both sides): a linear is {"w": (in, out), "b"?}, a
conv {"w": (out, in/groups, width), "b"?}, a transposed conv {"w": (in,
out, width), "b"?}, a norm {"scale", "bias"?}. Layouts are channel-last.

`Prec` selects the arithmetic of every matrix product (linears and
convolutions): "fp32"; "fp8", where both operands are rounded to float8
e4m3 with one scale a tensor (amax / 448) before an fp32 product: the
control that a sound bf16 program has to beat; or "bf16", operands
rounded to bfloat16: the yardstick of what bf16 rounding alone does to a
result.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@dataclass(frozen=True)
class Prec:
    mode: str = "fp32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """An operand as the product sees it."""
        x = x.float()
        if self.mode == "fp32":
            return x
        if self.mode == "bf16":
            return x.bfloat16().float()
        if self.mode != "fp8":
            raise ValueError(f"unknown precision {self.mode!r}")
        s = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).float() * s


FP32 = Prec("fp32")


def exact_fp32():
    """Matrix products and convolutions in full fp32 on a GPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def linear(p, x, prec: Prec = FP32):
    y = prec.q(x) @ prec.q(p["w"])
    return y + p["b"].float() if "b" in p else y


def conv1d(p, x, prec: Prec = FP32, *, stride=1, padding=0, dilation=1, groups=1):
    """x (B, T, C) -> (B, T', C'); padding an int or a (left, right) pair."""
    xc = prec.q(x).transpose(1, 2)
    if isinstance(padding, tuple):
        xc = F.pad(xc, padding)
        padding = 0
    b = p["b"].float() if "b" in p else None
    y = F.conv1d(xc, prec.q(p["w"]), b, stride=stride, padding=padding,
                 dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv_transpose1d(p, x, prec: Prec, stride, padding):
    b = p["b"].float() if "b" in p else None
    y = F.conv_transpose1d(prec.q(x).transpose(1, 2), prec.q(p["w"]), b, stride=stride,
                           padding=padding)
    return y.transpose(1, 2)


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps)


def rms_norm(p, x, eps=1e-5):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * p["scale"].float()


def attention(q, k, v, key_valid=None, causal=None):
    """q (B, Tq, H, D), k / v (B, Tk, H, D); key_valid (B, Tk) bool and
    causal (Tq, Tk) bool say which keys a query sees. Softmax in fp32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    keep = None
    if key_valid is not None:
        keep = key_valid[:, None, None, :]
    if causal is not None:
        keep = causal[None, None] if keep is None else keep & causal[None, None]
    if keep is not None:
        s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v.float())


def heads(x, n):
    return x.reshape(x.shape[0], x.shape[1], n, x.shape[2] // n)


def merge(x):
    return x.reshape(x.shape[0], x.shape[1], -1)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def snake(x, alpha):
    a = alpha.float()
    return x + torch.sin(x * a).square() / (a + 1e-9)
