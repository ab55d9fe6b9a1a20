"""Mel filterbanks and the three mel front-ends of the pipeline, the PyTorch
counterpart of `chatterbox_embed_tpu/ops/mel.py`.

The filterbank reproduces librosa.filters.mel (slaney scale, slaney
area-norm) in float64 numpy, cast to fp32 last, as the JAX package builds
it. Each front-end is a function of a waveform tensor and runs on its
device in fp32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import stft as stft_ops


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    return np.where(log_region,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=16)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None) -> np.ndarray:
    """(n_mels, n_fft//2+1) float32 filterbank, identical to librosa defaults."""
    fmax = fmax if fmax is not None else sr / 2.0
    n_freq = n_fft // 2 + 1
    fftfreqs = np.linspace(0.0, sr / 2.0, n_freq)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def _fb(like: torch.Tensor, *args) -> torch.Tensor:
    return torch.from_numpy(mel_filterbank(*args)).to(like.device)


def mel_spectrogram_24k(y: torch.Tensor, n_fft: int = 1920, num_mels: int = 80,
                        sampling_rate: int = 24_000, hop_size: int = 480,
                        win_size: int = 1920, fmin: float = 0.0,
                        fmax: float = 8000.0) -> torch.Tensor:
    """The 24 kHz mel of the S3Gen prompt features: manual reflect pad,
    center=False, log-compressed.

    y (B, T) in [-1, 1] -> (B, num_mels, T // hop_size) for T a hop multiple.
    """
    pad = (n_fft - hop_size) // 2
    y = F.pad(y.float()[:, None, :], (pad, pad), mode="reflect")[:, 0]
    real, imag = stft_ops.stft(y, n_fft, hop_size, stft_ops.hann_window(win_size),
                               win_length=win_size, center=False)
    spec = stft_ops.magnitude(real, imag, eps=1e-9)
    mel = _fb(spec, sampling_rate, n_fft, num_mels, fmin, fmax) @ spec
    return torch.log(mel.clamp_min(1e-5))


def log_mel_s3tokenizer(audio: torch.Tensor, n_fft: int = 400, hop: int = 160,
                        n_mels: int = 128) -> torch.Tensor:
    """The 16 kHz 128-bin log-mel of the S3 speech tokenizer (whisper
    style): power spectrum, log10, 8-dB dynamic floor.

    audio (B, T) -> (B, n_mels, n_frames), the trailing STFT frame dropped.
    """
    real, imag = stft_ops.stft(audio, n_fft, hop, stft_ops.hann_window(n_fft))
    power = (real * real + imag * imag)[..., :-1]
    mel = _fb(power, 16_000, n_fft, n_mels) @ power
    log_spec = torch.log10(mel.clamp_min(1e-10))
    floor = log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    return (log_spec + 4.0) / 4.0


def melspectrogram_ve(wav: torch.Tensor, n_fft: int = 400, hop: int = 160,
                      win: int = 400, n_mels: int = 40, fmin: float = 0.0,
                      fmax: float = 8000.0, power: float = 2.0) -> torch.Tensor:
    """The voice encoder's 16 kHz 40-bin mel: unscaled, (..., M, T) layout,
    librosa-stft semantics."""
    real, imag = stft_ops.stft(wav, n_fft, hop, stft_ops.hann_window(win),
                               win_length=win, center=True, pad_mode="reflect")
    mag = stft_ops.magnitude(real, imag)
    if power != 1.0:
        mag = mag ** power
    return _fb(mag, 16_000, n_fft, n_mels, fmin, fmax) @ mag
