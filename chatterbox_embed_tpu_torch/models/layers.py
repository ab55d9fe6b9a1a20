"""Minimal functional NN toolkit, the PyTorch counterpart of
`chatterbox_embed_tpu/models/layers.py`.

Models in the port are plain functions over nested dicts of tensors, with the
JAX package's tree layout, so each function reads like its JAX counterpart
and the tests compare like with like. Public layouts stay channel-last.

Parameter layouts (what `weights.from_jax_params` produces):
- Linear:    {"w": (in, out), "b": (out,)?}       y = x @ w + b (as in JAX);
             int8: {"w_q": (in, out) int8, "scale": (1, out) fp32, "b"?}
- Conv1d:    {"w": (out, in/groups, width), "b"}  torch's layout for F.conv1d
- Conv2d:    {"w": (out, in, kh, kw), "b"}        torch's layout for F.conv2d
- ConvT1d:   {"w": (in, out, width), "b"}         torch's layout for F.conv_transpose1d
- Norms:     {"scale": (c,), "bias": (c,)}; batch norm adds "mean", "var"
- Embedding: {"w": (vocab, dim)}
Matmul-bearing ops take a compute `dtype` and cast the weight to it (a no-op
when the weights are stored in that dtype already).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..kernels.flash_attention import flash_attention


def _cast(p, dtype):
    return p.to(dtype) if dtype is not None and p.dtype != dtype else p


# ---------------------------------------------------------------------------
# initialisers (random weights for from_random and shape-only trees)
# ---------------------------------------------------------------------------

class Init:
    """Random-tensor source for model init: a torch.Generator seeded from
    `seed` on `device` (None: the card). On the "meta" device it makes shape-only tensors,
    which is how `weights.from_jax_params` learns the expected tree.
    Distributions follow the JAX package's initialisers (torch defaults)."""

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def uniform(self, shape, bound):
        if self.gen is None:
            return torch.empty(shape, device=self.device)
        r = torch.rand(shape, generator=self.gen, device=self.device)
        return r * (2 * bound) - bound

    def normal(self, shape, std=1.0):
        if self.gen is None:
            return torch.empty(shape, device=self.device)
        return torch.randn(shape, generator=self.gen, device=self.device) * std

    def ones(self, shape):
        return torch.ones(shape, device=self.device)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device)


def linear_init(init: Init, d_in, d_out, bias=True):
    """torch.nn.Linear default init (kaiming uniform fan_in, bias 1/sqrt(fan))."""
    bound = 1.0 / math.sqrt(d_in)
    p = {"w": init.uniform((d_in, d_out), math.sqrt(3.0) * bound)}
    if bias:
        p["b"] = init.uniform((d_out,), bound)
    return p


def embedding_init(init: Init, vocab, dim, std=1.0):
    return {"w": init.normal((vocab, dim), std)}


def layer_norm_init(init: Init, dim):
    return {"scale": init.ones((dim,)), "bias": init.zeros((dim,))}


def batch_norm_init(init: Init, dim):
    """Eval-form batch norm: running statistics beside the affine pair."""
    return {"scale": init.ones((dim,)), "bias": init.zeros((dim,)),
            "mean": init.zeros((dim,)), "var": init.ones((dim,))}


def conv1d_init(init: Init, width, d_in, d_out, bias=True, groups=1):
    bound = 1.0 / math.sqrt(d_in // groups * width)
    p = {"w": init.uniform((d_out, d_in // groups, width), math.sqrt(3.0) * bound)}
    if bias:
        p["b"] = init.uniform((d_out,), bound)
    return p


def conv2d_init(init: Init, kh, kw, d_in, d_out, bias=True):
    bound = 1.0 / math.sqrt(d_in * kh * kw)
    p = {"w": init.uniform((d_out, d_in, kh, kw), math.sqrt(3.0) * bound)}
    if bias:
        p["b"] = init.uniform((d_out,), bound)
    return p


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def linear(p, x, dtype=None):
    """y = x @ w (+ b) in the compute dtype. An int8 linear ({"w_q",
    "scale"}, `quantize_linear`) dequantises its weight first, as the JAX
    package's `linear` does: w = w_q * scale with the product rounded to
    the compute dtype, then the same matmul (XLA's product there, outside
    any kernel; torch.matmul here)."""
    d = dtype or x.dtype
    if "w_q" in p:
        w = p["w_q"].to(d) * _cast(p["scale"], d)
    else:
        w = _cast(p["w"], d)
    y = torch.matmul(x.to(d), w)
    if "b" in p:
        y = y + _cast(p["b"], y.dtype)
    return y


def quantize_linear(p, axis: int = 0):
    """fp weight dict -> int8 dict {w_q, scale(, b)}; symmetric per output
    channel. The port's copy of `chatterbox_embed_tpu/models/layers.py:
    quantize_linear` with its arithmetic: scale = amax / 127 + 1e-12 in fp32,
    w_q = clip(round(w / scale), -127, 127) with round-half-to-even
    (np.round's and torch.round's). It runs in torch, on the weight's
    device, with both divisions tensor by tensor (IEEE's correctly rounded
    division, as numpy's; torch on CUDA multiplies by a Python scalar's
    reciprocal instead), so a tree on the card quantises there. The bias is
    kept as it is."""
    w = p["w"].detach().float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0) + 1e-12
    w_q = torch.round(w / scale).clamp(-127, 127).to(torch.int8)
    out = {"w_q": w_q, "scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def embedding(p, ids):
    return p["w"][ids]


def layer_norm(p, x, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def rms_norm(p, x, eps=1e-5):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def batch_norm(p, x, eps=1e-5):
    """Batch norm in eval form over the last (channel) axis."""
    inv = torch.rsqrt(p["var"] + eps) * p["scale"]
    return ((x.float() - p["mean"]) * inv + p["bias"]).to(x.dtype)


def _same_padding(t: int, width: int, stride: int, dilation: int):
    """XLA's SAME padding (lo, hi) for a 1-D window."""
    out = -(-t // stride)
    total = max((out - 1) * stride + (width - 1) * dilation + 1 - t, 0)
    return total // 2, total - total // 2


def conv1d(p, x, stride=1, padding="SAME", dilation=1, groups=1, dtype=None):
    """x: (B, T, C_in) -> (B, T', C_out). padding: 'SAME'|'VALID'|int|(lo,hi)."""
    d = dtype or x.dtype
    w = _cast(p["w"], d)
    if padding == "SAME":
        padding = _same_padding(x.shape[1], w.shape[-1], stride, dilation)
    elif padding == "VALID":
        padding = 0
    xc = x.to(d).transpose(1, 2)
    if isinstance(padding, tuple):
        xc = F.pad(xc, padding)
        padding = 0
    b = _cast(p["b"], d) if "b" in p else None
    y = F.conv1d(xc, w, b, stride=stride, padding=padding, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def conv2d(p, x, stride=(1, 1), padding=0, dtype=None):
    """x: (B, H, W, C_in) channel-last -> (B, H', W', C_out); padding is one
    int for both axes."""
    d = dtype or x.dtype
    b = _cast(p["b"], d) if "b" in p else None
    y = F.conv2d(x.to(d).permute(0, 3, 1, 2), _cast(p["w"], d), b, stride=stride,
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose1d(p, x, stride, padding, dtype=None):
    """torch ConvTranspose1d semantics; p["w"]: (in, out, width).

    x: (B, T, C_in) -> (B, (T-1)*stride - 2*padding + width, C_out)
    """
    d = dtype or x.dtype
    b = _cast(p["b"], d) if "b" in p else None
    y = F.conv_transpose1d(x.to(d).transpose(1, 2), _cast(p["w"], d), b,
                           stride=stride, padding=padding)
    return y.transpose(1, 2)


# ---------------------------------------------------------------------------
# attention: written out (einsum, masked fp32 softmax, einsum); the decode
# step's attention is the flash-decode kernel (kernels/flash_decode.py) and
# batched self-attention the flash-attention kernel (mha_flash)
# ---------------------------------------------------------------------------

def mha(q, k, v, mask=None):
    """q: (B, Tq, H, D); k, v: (B, Tk, H, D); mask: bool (..., Tq, Tk).

    Logits and softmax in fp32 regardless of input dtype (the inputs are
    cast to fp32, which keeps bf16 products exact, as JAX's
    preferred_element_type=float32 does).
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e10)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def use_flash_attention(rows: int) -> bool:
    """The batched self-attention gate of the JAX package (>= 4 rows). The
    port takes it on every device: on the CPU the kernel's wrapper runs its
    plain version."""
    return rows >= 4


def mha_flash(q, k, v, key_valid=None):
    """Self-attention through the flash-attention kernel
    (kernels/flash_attention.py), with `mha`'s key-mask semantics.

    q, k, v: (B, T, H, D); key_valid: (B, T) bool or None (all valid)."""
    if key_valid is None:
        key_valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    return flash_attention(q, k, v, key_valid.contiguous())


def split_heads(x, n_heads):
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def merge_heads(x):
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


# activations
def mish(x):
    return x * torch.tanh(F.softplus(x))


def snake(x, alpha):
    """Snake activation x + sin^2(alpha x)/alpha."""
    a = alpha.to(x.dtype)
    return x + torch.sin(x * a).square() / (a + 1e-9)
