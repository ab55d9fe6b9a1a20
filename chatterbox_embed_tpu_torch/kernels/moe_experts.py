"""The routed experts' grouped SwiGLU (K7) for T3's DeepSeek-V2 backbone
(models/deepseek_v2.py). It replaces no TPU kernel: the JAX package runs
no mixture of experts.

`grouped_swiglu(x, offsets, w_gate, w_up, w_down)` takes rows x (N, D)
sorted by expert, expert e owning rows [offsets[e], offsets[e + 1]), and
returns y (N, D) fp32 with y = (silu(x Wg[e]) * (x Wu[e])) Wd[e] row by
row, the inner product h rounded to bf16 as the kernel stores it. On a
CUDA tensor it launches the hand-written kernel in `csrc/moe_experts.cu`
(design notes there): two launches, each a persistent grid of one block an
SM that streams the touched experts' weight tiles by TMA into `wgmma`
against the experts' rows; the work items come from the offsets on the
device, so a CUDA graph holds it whatever the routing. On a CPU
tensor it runs `grouped_swiglu_reference`, the plain PyTorch loop over the
experts, which reads the offsets on the host. There is no other path: a
CUDA call that the kernel cannot take raises.

The library is compiled with `nvcc` for sm_90a the first time a CUDA
tensor arrives (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

SOURCE = _build.CSRC / "moe_experts.cu"
COLS = 128             # the output widths' multiple (the kernel's tiles are 64 wide)
DEPTH_STEP = 64        # the depth of a TMA stage
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def grouped_swiglu_reference(x, offsets, w_gate, w_up, w_down) -> torch.Tensor:
    """The plain version: a loop over the experts in the compute dtype, the
    down product's sum in fp32. Reads the offsets on the host."""
    off = offsets.tolist()
    y = torch.zeros((x.shape[0], w_down.shape[2]), dtype=torch.float32, device=x.device)
    for e in range(w_gate.shape[0]):
        a, b = off[e], off[e + 1]
        if a == b:
            continue
        xe = x[a:b]
        h = F.silu(xe @ w_gate[e].to(x.dtype)) * (xe @ w_up[e].to(x.dtype))
        y[a:b] = h.float() @ w_down[e].float()
    return y


def _library():
    return _build.load(SOURCE, "cbx_moe_experts", _ARGTYPES)


def grouped_swiglu(x: torch.Tensor, offsets: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """x (N, D); offsets (E + 1,) int32; w_gate, w_up (E, D, F); w_down
    (E, F, D). On the card all bf16 and contiguous, D and F multiples of 128
    and of 64. Returns y (N, D) fp32. A launch adds one to
    `grouped_swiglu.launches`."""
    if x.device.type != "cuda":
        return grouped_swiglu_reference(x, offsets, w_gate, w_up, w_down)
    n, d = x.shape
    e, d2, f = w_gate.shape
    for name, t, shape in (("x", x, (n, d)), ("w_gate", w_gate, (e, d, f)),
                           ("w_up", w_up, (e, d, f)), ("w_down", w_down, (e, f, d))):
        if (t.dtype != torch.bfloat16 or tuple(t.shape) != shape or not t.is_contiguous()
                or t.device != x.device):
            raise ValueError(f"grouped_swiglu: want a contiguous bf16 {name} {shape} on "
                             f"{x.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if (offsets.dtype != torch.int32 or tuple(offsets.shape) != (e + 1,)
            or offsets.device != x.device):
        raise ValueError(f"grouped_swiglu: want int32 offsets ({e + 1},) on {x.device}")
    if d % COLS or f % COLS or d % DEPTH_STEP or f % DEPTH_STEP:
        raise ValueError(f"grouped_swiglu: D={d} and F={f} must be multiples of {COLS}")
    h = torch.empty((n, f), dtype=torch.bfloat16, device=x.device)
    y = torch.empty((n, d), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _library().cbx_moe_experts(x.data_ptr(), offsets.data_ptr(), w_gate.data_ptr(),
                                    w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(),
                                    y.data_ptr(), e, d, f, stream)
    if rc != 0:
        raise RuntimeError(f"moe_experts kernel launch failed: cudaError {rc}")
    grouped_swiglu.launches += 1
    return y


grouped_swiglu.launches = 0
