"""STFT / iSTFT as matmuls against a DFT basis, the PyTorch counterpart of
`chatterbox_embed_tpu/ops/stft.py`: the speech front-ends' forward
transforms (n_fft 400 / 1920) and the vocoder's n_fft=16 pair.

Framing is a strided view, the transform one fp32 matmul against a cos/sin
basis, and the inverse an overlap-add written as a transposed convolution
with an identity kernel, normalised by the summed squared window (torch.istft
semantics: center, reflect padding).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import constant


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window."""
    if n == 1:
        return np.ones(1, np.float32)
    k = np.arange(n)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _dft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward rDFT basis: (n_fft, n_freq) cos and -sin matrices."""
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse rDFT basis (n_freq, n_fft): x = real @ C + imag @ S, with the
    Hermitian symmetry folded in (interior bins count double)."""
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((n_freq, 1), 2.0 / n_fft)
    w[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        w[-1] = 1.0 / n_fft
    return (np.cos(ang) * w).astype(np.float32), (-np.sin(ang) * w).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _nola_denominator(win_bytes: bytes, n_fft: int, hop: int, n_frames: int) -> np.ndarray:
    """Sum of squared windows over the overlapped frames, (out_len,)."""
    win2 = np.frombuffer(win_bytes, np.float32).astype(np.float64) ** 2
    out_len = n_fft + hop * (n_frames - 1)
    imp = np.zeros(out_len - n_fft + 1, np.float64)
    imp[::hop] = 1.0
    return np.convolve(imp, win2, mode="full")[:out_len].astype(np.float32)


def _t(key, a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The constant `a` (named by `key`) on like's device, copied once."""
    return constant(("stft",) + key, like.device, lambda: a)


def frame(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """Slice (..., T) into overlapping frames (..., n_frames, frame_length);
    T must be at least frame_length (callers pad)."""
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int, hop_length: int, window: np.ndarray,
         win_length: int | None = None, center: bool = True, pad_mode: str = "reflect"):
    """Matmul STFT with torch.stft / librosa.stft semantics.

    x: (..., T) waveform; window: (win_length,), padded symmetrically to
    n_fft when shorter; centred frames are padded by n_fft // 2 on both sides
    in `pad_mode`. Returns (real, imag), each (..., n_freq, n_frames) fp32.
    The transform is one fp32 matmul against the cos/sin basis (on the card a
    fp32 matmul runs in full fp32 unless TF32 was switched on)."""
    win_length = win_length or n_fft
    window = np.asarray(window, np.float32)
    if win_length < n_fft:
        lp = (n_fft - win_length) // 2
        window = np.pad(window, (lp, n_fft - win_length - lp))
    x = x.float()
    if center:
        lead = x.shape[:-1]
        pad = n_fft // 2
        x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode=pad_mode)
        x = x.reshape(lead + (x.shape[-1],))
    frames = frame(x, n_fft, hop_length) * _t(("window", window.tobytes()), window, x)
    cos_b, msin_b = _dft_basis(n_fft)
    real = frames @ _t(("dft_cos", n_fft), cos_b, x)
    imag = frames @ _t(("dft_msin", n_fft), msin_b, x)
    return real.transpose(-1, -2), imag.transpose(-1, -2)


def magnitude(real: torch.Tensor, imag: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    return torch.sqrt(real * real + imag * imag + eps)


def istft(real: torch.Tensor, imag: torch.Tensor, n_fft: int, hop_length: int,
          window: np.ndarray) -> torch.Tensor:
    """Inverse STFT with overlap-add, NOLA-normalised, centred frames.
    real, imag: (B, n_freq, n_frames) -> (B, T)."""
    window = np.asarray(window, np.float32)
    cos_b, msin_b = _idft_basis(n_fft)
    frames = (real.transpose(-1, -2) @ _t(("idft_cos", n_fft), cos_b, real)
              + imag.transpose(-1, -2) @ _t(("idft_msin", n_fft), msin_b, real))
    frames = frames * _t(("window", window.tobytes()), window, real)  # (B, n_frames, n_fft)
    n_frames = frames.shape[-2]
    out_len = n_fft + hop_length * (n_frames - 1)
    # overlap-add: out[f * hop + k] += frames[f, k], a transposed conv with
    # the n_fft frame bins as input channels and an identity kernel
    eye = torch.eye(n_fft, dtype=frames.dtype, device=frames.device)[:, None, :]
    sig = F.conv_transpose1d(frames.transpose(1, 2), eye, stride=hop_length)[:, 0]
    wsq = _nola_denominator(window.tobytes(), n_fft, hop_length, n_frames)
    sig = sig / _t(("nola", window.tobytes(), n_fft, hop_length, n_frames), wsq,
                   sig).clamp_min(1e-11)
    return sig[..., n_fft // 2: out_len - n_fft // 2]
