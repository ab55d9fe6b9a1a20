"""LayerNorm over the last axis in one launch (K8), for S3Gen's CFM estimator
(models/flow_decoder.py) and flow encoder (models/conformer.py). It
replaces no TPU kernel: XLA fuses the norm's chain there, where eager
PyTorch launches it as ~10 kernels.

`layer_norm(p, x, eps, out_dtype)` normalises x over its last axis with
the fp32 `scale` and `bias` of `p` and returns the result in `out_dtype`
(x's dtype when None): the fp32 norm rounded once. On a CUDA tensor it
launches the hand-written kernel in `csrc/layer_norm.cu` (design notes
there), for widths 256, 512 and 1,024, fp32 or bf16 in and out, on x
either contiguous or channel-first (x.transpose(-1, -2) contiguous, as a
conv's output seen channel-last is); the output keeps x's layout. On a CPU
tensor it runs `layer_norm_reference`, the plain PyTorch arithmetic of
`models/layers.py:layer_norm`. There is no other path: a CUDA call the
kernel cannot take raises.

With grad enabled and an input that requires it, the call goes through a
`torch.autograd.Function` whose forward is the same launch and whose
backward is the plain version's gradient, recomputed (the TPU had no
kernel here, so the backward is none either). The library is compiled with
`nvcc` for sm_90a the first time a CUDA tensor arrives (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

SOURCE = _build.CSRC / "layer_norm.cu"
WIDTHS = (256, 512, 1024)
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_long] + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])


def layer_norm_reference(p, x, eps=1e-5, out_dtype=None):
    """The plain version: `layers.layer_norm`'s arithmetic in fp32, rounded
    once to `out_dtype` (x's dtype when None)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(out_dtype or x.dtype)


def layer_norm(p, x, eps=1e-5, out_dtype=None):
    """LayerNorm of x over its last axis, stored in `out_dtype` (x's dtype
    when None). CPU tensors take the plain version; CUDA tensors launch the
    kernel (and count the launch in `layer_norm.launches`) or raise."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return layer_norm_reference(p, x, eps, out_dtype)
    scale, bias = p["scale"], p["bias"]
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps, out_dtype)
    return _launch(x, scale, bias, eps, out_dtype)


class _LayerNorm(torch.autograd.Function):
    """K8 forward; the plain version's gradient, recomputed, backward."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.out_dtype = eps, out_dtype
        return _launch(x, scale, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        want = [i for i in range(3) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            x, scale, bias = (t.detach().requires_grad_(i in want) for i, t in enumerate(saved))
            y = layer_norm_reference({"scale": scale, "bias": bias}, x, ctx.eps, ctx.out_dtype)
            grads = torch.autograd.grad(y, [(x, scale, bias)[i] for i in want], dy)
        out = [None, None, None]
        for i, g in zip(want, grads):
            out[i] = g
        return (*out, None, None)


def _layout(x) -> int:
    """0 if x is contiguous, 1 if it is channel-first (its last two axes
    swapped, contiguous); raises otherwise."""
    if x.is_contiguous():
        return 0
    if x.dim() >= 2 and x.transpose(-1, -2).is_contiguous():
        return 1
    raise ValueError(f"layer_norm: x {tuple(x.shape)} with strides {x.stride()} is neither "
                     f"contiguous nor channel-first (its last axis is not contiguous)")


def _check(x, scale, bias, out_dtype) -> None:
    width = x.shape[-1]
    if width not in WIDTHS:
        raise ValueError(f"layer_norm: width {width} not supported {WIDTHS}")
    if x.dtype not in _BF16 or out_dtype not in _BF16:
        raise ValueError(f"layer_norm: dtypes {x.dtype} -> {out_dtype} not supported "
                         "(float32, bfloat16)")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.dtype != torch.float32 or tuple(t.shape) != (width,) or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"layer_norm: want a contiguous fp32 {name} ({width},) on "
                             f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: unsupported device {x.device}")
    if x.data_ptr() % 16 or scale.data_ptr() % 16 or bias.data_ptr() % 16:
        raise ValueError("layer_norm: x, scale and bias must start on a 16-byte boundary")


def _launch(x, scale, bias, eps, out_dtype):
    """One K8 launch outside autograd: the output in x's layout."""
    _check(x, scale, bias, out_dtype)
    cols = _layout(x)
    width = x.shape[-1]
    t_len = x.shape[-2] if cols else 1
    if cols:
        y = torch.empty((*x.shape[:-2], width, t_len), dtype=out_dtype,
                        device=x.device).transpose(-1, -2)
    else:
        y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _build.load(SOURCE, "cbx_layer_norm", _ARGTYPES).cbx_layer_norm(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), x.numel() // width,
        t_len, width, _BF16[x.dtype], _BF16[out_dtype], cols, float(eps), stream)
    if rc != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: cudaError {rc}")
    layer_norm.launches += 1
    return y


layer_norm.launches = 0
