"""Kimi Delta Attention's recurrence (K9) for T3's Kimi-Linear backbone
(models/kimi_linear.py). It replaces no TPU kernel: the JAX package has no
linear attention.

`kda_recurrent(q, k, v, g, beta, state, skip, read_state)` runs the gated
delta rule token by token, each (row, head) on its own dk x dv state S in
fp32 (fla's `fused_recurrent_kda`, `modeling_kimi.py`'s decode):

    S' = Diag(exp(g_t)) S_{t-1}
    S_t = S' + beta_t k_t (v_t - S'^T k_t)^T
    o_t = S_t^T q_t

q and k come L2-normalised (q also scaled by dk^-0.5), g is the log of
the per-key-channel decay. The first skip[b] positions of row b (its left
pad) are passed over: the state does not see them and their outputs are
0. `state` (B, H, dk, dv) is read first (`read_state`; otherwise the
recurrence starts from zero, as a prefill does) and holds the final state
after the call.

On a CUDA tensor it launches the hand-written kernel in
`csrc/kda_recurrent.cu` (design notes there): one warp a (row, head,
32-column value tile), its state tile held in registers across all of the
call's tokens, so a decode call reads each tile once and writes it once,
and a prefill call only writes. Nothing reads the host and nothing is
allocated but the output, so a CUDA graph holds it. On a CPU tensor it
runs `kda_recurrent_reference`, the plain loop. There is no other path: a
CUDA call that the kernel cannot take raises.

Prompts are at most a few hundred positions (the engine's context), so
the chunked (WY) form that long prefills want is not built: a prefill is
the same token-by-token walk.

The library is compiled with `nvcc` for sm_90a the first time a CUDA
tensor arrives (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

SOURCE = _build.CSRC / "kda_recurrent.cu"
KEY_DIM = 128          # the kernel's dk (a state column lives in a lane's registers)
TILE = 32              # value columns a warp
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def kda_recurrent_reference(q, k, v, g, beta, state, skip=None, read_state=True):
    """The plain version, token by token in fp32; the arguments as
    `kda_recurrent`'s. Returns o (B, T, H, dv) fp32; `state` is written."""
    b, t = q.shape[:2]
    s = state.float() if read_state else torch.zeros_like(state, dtype=torch.float32)
    o = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    pos = torch.arange(t, device=q.device)
    live = (pos[None] >= (skip.long()[:, None] if skip is not None else 0)).expand(b, t)
    for i in range(t):
        kt = k[:, i].float()
        s1 = s * torch.exp(g[:, i].float())[..., None]
        u = beta[:, i].float()[..., None] * (v[:, i].float()
                                             - torch.einsum("bhk,bhkv->bhv", kt, s1))
        s1 = s1 + kt[..., None] * u[:, :, None, :]
        on = live[:, i, None, None, None]
        s = torch.where(on, s1, s)
        o[:, i] = torch.where(on[..., 0], torch.einsum("bhk,bhkv->bhv", q[:, i].float(), s1), 0.0)
    state.copy_(s)
    return o


def _library():
    return _build.load(SOURCE, "cbx_kda_recurrent", _ARGTYPES)


def kda_recurrent(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                  beta: torch.Tensor, state: torch.Tensor, skip: Optional[torch.Tensor] = None,
                  read_state: bool = True) -> torch.Tensor:
    """q, k, g (B, T, H, dk); v (B, T, H, dv); beta (B, T, H); state (B, H,
    dk, dv), read (with `read_state`) and written in place; skip (B,) int32
    leading positions to pass over, or None. On the card all fp32 and
    contiguous, dk 128 and dv a multiple of 32. Returns o (B, T, H, dv)
    fp32. A launch adds one to `kda_recurrent.launches`."""
    if q.device.type != "cuda":
        return kda_recurrent_reference(q, k, v, g, beta, state, skip, read_state)
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    for name, x, shape in (("q", q, (b, t, h, dk)), ("k", k, (b, t, h, dk)),
                           ("g", g, (b, t, h, dk)), ("v", v, (b, t, h, dv)),
                           ("beta", beta, (b, t, h)), ("state", state, (b, h, dk, dv))):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous()
                or x.device != q.device):
            raise ValueError(f"kda_recurrent: want a contiguous fp32 {name} {shape} on "
                             f"{q.device}; got {x.dtype} {tuple(x.shape)} on {x.device}")
    if skip is not None and (skip.dtype != torch.int32 or tuple(skip.shape) != (b,)
                             or skip.device != q.device or not skip.is_contiguous()):
        raise ValueError(f"kda_recurrent: want int32 skip ({b},) on {q.device}")
    if dk != KEY_DIM or dv % TILE:
        raise ValueError(f"kda_recurrent: dk={dk} must be {KEY_DIM} and dv={dv} a multiple "
                         f"of {TILE}")
    o = torch.empty((b, t, h, dv), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _library().cbx_kda_recurrent(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), beta.data_ptr(),
        state.data_ptr() if read_state else None, state.data_ptr(), o.data_ptr(),
        None if skip is None else skip.data_ptr(), b, t, h, dk, dv, stream)
    if rc != 0:
        raise RuntimeError(f"kda_recurrent kernel launch failed: cudaError {rc}")
    kda_recurrent.launches += 1
    return o


kda_recurrent.launches = 0
