"""Polyphase windowed-sinc resampling as a strided convolution, the PyTorch
counterpart of `chatterbox_embed_tpu/ops/resample.py`.

Equivalent to torchaudio.transforms.Resample (sinc_interp_hann,
lowpass_filter_width=6, rolloff=0.99). The kernel is built in float64 numpy
and cached per reduced (orig, new) pair; the convolution is one fp32
F.conv1d with stride `orig` and `new` output channels (the phases).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import full_fp32


@functools.lru_cache(maxsize=64)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: int = 6,
                 rolloff: float = 0.99) -> tuple[np.ndarray, int]:
    """Returns (kernel (new, 1, 2*width + orig), width)."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = (-np.arange(new_freq, dtype=np.float64) / new_freq)[:, None] + idx
    t *= base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)

    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    tpi = t * np.pi
    kernel = np.where(tpi == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1.0, tpi))
    kernel *= window * base_freq / orig_freq
    return kernel[:, None, :].astype(np.float32), width


def resample(wav: torch.Tensor, orig_sr: int, new_sr: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99) -> torch.Tensor:
    """Resample (..., T) -> (..., ceil(T * new / orig)), fp32, on wav's device.
    TF32 is kept out of the convolution, so the card computes what the CPU
    does."""
    if orig_sr == new_sr:
        return wav
    g = math.gcd(int(orig_sr), int(new_sr))
    orig, new = int(orig_sr) // g, int(new_sr) // g
    kernel_np, width = _sinc_kernel(orig, new, lowpass_filter_width, rolloff)

    shape = wav.shape
    t = shape[-1]
    x = F.pad(wav.reshape(-1, 1, t).float(), (width, width + orig))
    with full_fp32():
        out = F.conv1d(x, torch.from_numpy(kernel_np).to(x.device), stride=orig)
    out = out.transpose(-1, -2).reshape(x.shape[0], -1)       # (B, n_blocks * new)
    target_len = int(math.ceil(new * t / orig))
    return out[:, :target_len].reshape(shape[:-1] + (target_len,))
