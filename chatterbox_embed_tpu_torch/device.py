"""Where the port runs: the card, unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import numpy as np
import torch


def default_device() -> torch.device:
    """The device of every entry point that is given none: the first CUDA
    card. Without one this raises; the port never steps down to the CPU on
    its own (tests ask for it with device="cpu")."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card: torch.cuda.is_available() is False. The port's entry points "
            "run on the card by default; pass device=\"cpu\" to run on the CPU.")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """`device`, or the default device when it is None."""
    return default_device() if device is None else torch.device(device)


_CONSTANTS: dict = {}


def constant(key, device, make: Callable[[], np.ndarray]) -> torch.Tensor:
    """A host-made constant on `device`, copied there once per (key,
    device): `make()` gives its numpy array the first time. A copy from the
    host is not allowed inside a CUDA graph capture (streaming.py captures
    the stream's first chunk), and one made on every call costs a transfer
    each time. `key` must name everything the array depends on."""
    k = (key, str(torch.device(device)))
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
    return t


def lap(timings: Optional[dict], name: str, t0: float, device: torch.device) -> float:
    """Add the seconds since `t0` to timings[name], after `device` has
    finished its queued work, and return the clock for the next part. With
    `timings` None nothing is waited for or recorded."""
    if timings is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        timings[name] = timings.get(name, 0.0) + time.time() - t0
    return time.time()


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls and convolutions in full fp32 inside the block: cuDNN's
    convolutions take TF32 by default, which keeps about three decimal
    digits; the conditioning encoders (a speaker embedding, a rounding to
    speech tokens) are computed without it, as on the CPU."""
    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm
