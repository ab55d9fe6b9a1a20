"""Kaldi-compatible 80-bin log-fbank for the CAMPPlus speaker encoder, the
PyTorch counterpart of `chatterbox_embed_tpu/ops/fbank.py`.

Reproduces torchaudio.compliance.kaldi.fbank(num_mel_bins=80) defaults
(povey window, preemphasis 0.97, DC removal, snip_edges, power spectrum, HTK
mel, log floor at float-eps). Banks and window are built in float64 numpy
and cast to fp32 last.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import stft as stft_ops

_EPS = 1.1920928955078125e-07  # float32 machine eps, kaldi's log floor


def _mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


@functools.lru_cache(maxsize=4)
def kaldi_mel_banks(num_bins: int = 80, window_size_padded: int = 512,
                    sample_freq: float = 16_000.0, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """(num_bins, window_size_padded // 2) kaldi-style triangular banks."""
    if high_freq <= 0.0:
        high_freq = sample_freq / 2.0 + high_freq
    num_fft_bins = window_size_padded // 2
    fft_bin_width = sample_freq / window_size_padded
    mel_low = _mel_htk(low_freq)
    mel_high = _mel_htk(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta

    mel = _mel_htk(fft_bin_width * np.arange(num_fft_bins))[None, :]
    up = (mel - left_mel) / (center_mel - left_mel)
    down = (right_mel - mel) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up, down))
    return banks.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _povey_window(n: int) -> np.ndarray:
    k = np.arange(n)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))
    return (hann ** 0.85).astype(np.float32)


def kaldi_fbank(wav: torch.Tensor, num_mel_bins: int = 80,
                sample_freq: int = 16_000, frame_length_ms: float = 25.0,
                frame_shift_ms: float = 10.0, preemphasis: float = 0.97,
                remove_dc_offset: bool = True) -> torch.Tensor:
    """wav (..., T) float in [-1, 1] -> (..., n_frames, num_mel_bins)."""
    win = int(sample_freq * frame_length_ms / 1000.0)   # 400
    hop = int(sample_freq * frame_shift_ms / 1000.0)    # 160
    padded = 1 << (win - 1).bit_length()                 # 512

    frames = stft_ops.frame(wav.float(), win, hop)       # (..., F, win)
    if remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if preemphasis != 0.0:
        first = frames[..., :1] - preemphasis * frames[..., :1]
        rest = frames[..., 1:] - preemphasis * frames[..., :-1]
        frames = torch.cat([first, rest], dim=-1)
    dev = frames.device
    frames = frames * torch.from_numpy(_povey_window(win)).to(dev)
    frames = F.pad(frames, (0, padded - win))

    cos_b, msin_b = stft_ops._dft_basis(padded)
    # kaldi drops the nyquist bin
    real = frames @ torch.from_numpy(np.ascontiguousarray(cos_b[:, :-1])).to(dev)
    imag = frames @ torch.from_numpy(np.ascontiguousarray(msin_b[:, :-1])).to(dev)
    power = real * real + imag * imag
    banks = torch.from_numpy(kaldi_mel_banks(num_mel_bins, padded, float(sample_freq))).to(dev)
    mel = power @ banks.T
    return torch.log(mel.clamp_min(_EPS))
