"""The S3 speech tokenizer v2 (25 Hz), 16 kHz audio -> speech tokens, for
one source: a whisper-style 128-bin log-mel, two stride-2 convolutions,
blocks of attention with an FSMN memory branch, and finite scalar
quantisation (8 dims x 3 levels).

Tokens are a rounding: `pre_round` returns the values that are rounded,
so a comparison can leave out positions that lie on a rounding boundary.
`cfg` is the configuration file's "s3gen"["tokenizer"] dict.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import nn
from .nn import FP32, Prec

FSQ_SCALE = 0.9990000128746033       # 0.999 as the checkpoint's fp32 rounds it
SR = 16_000


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                    m * (200.0 / 3))


@lru_cache(maxsize=4)
def mel_filters(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-scale, area-normalised triangular filters (librosa's default)."""
    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (pts[2:] - pts[:-2]))[:, None]
    return w.astype(np.float32)


def log_mel(wav: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(T,) 16 kHz -> (T // hop, 128): power spectrum, log10, an 8 dB floor
    under the maximum, (x + 4) / 4."""
    n_fft, hop = cfg["n_fft"], cfg["hop"]
    spec = torch.stft(wav.float(), n_fft, hop, window=torch.hann_window(n_fft, device=wav.device),
                      center=True, pad_mode="reflect", return_complex=True)
    power = spec.abs().square()[:, :-1]
    fb = torch.from_numpy(mel_filters(SR, n_fft, cfg["n_mels"])).to(wav.device)
    logm = torch.log10((fb @ power).clamp_min(1e-10))
    logm = torch.maximum(logm, logm.max() - 8.0)
    return ((logm + 4.0) / 4.0).T


def pad(wav: np.ndarray) -> np.ndarray:
    """Zero-pad to ceil(seconds x 25) tokens, computed in floating point as
    Chatterbox pads a source (so a length of exactly k tokens can take a
    (k + 1)-th token of silence)."""
    n_tokens = int(np.ceil(wav.shape[-1] / SR * 25))
    return np.pad(wav, (0, max(0, n_tokens * (SR // 25) - wav.shape[-1])))


def pre_round(p, wav: torch.Tensor, cfg: dict, prec: Prec = FP32) -> torch.Tensor:
    """(T_tok, 8): tanh(proj(h)) * 0.999, the values FSQ rounds. wav: a
    padded source (`pad`)."""
    x = log_mel(wav, cfg)[None]
    x = F.gelu(nn.conv1d(p["conv1"], x, prec, stride=2, padding=1), approximate="tanh")
    x = F.gelu(nn.conv1d(p["conv2"], x, prec, stride=2, padding=1), approximate="tanh")
    nh, k = cfg["n_heads"], cfg["fsmn_kernel"]
    for b in p["blocks"]:
        h = nn.layer_norm(b["ln1"], x, 1e-6)
        q = nn.heads(nn.linear(b["q"], h, prec), nh)
        kk = nn.heads(nn.linear(b["k"], h, prec), nh)
        v = nn.linear(b["v"], h, prec)
        lo = (k - 1) // 2
        mem = nn.conv1d(b["fsmn"], v, prec, padding=(lo, k - 1 - lo), groups=v.shape[-1]) + v
        att = nn.merge(nn.attention(q, kk, nn.heads(v, nh)))
        x = x + nn.linear(b["o"], att, prec) + mem
        h = nn.layer_norm(b["ln2"], x)
        x = x + nn.linear(b["fc2"], F.gelu(nn.linear(b["fc1"], h, prec)), prec)
    return torch.tanh(nn.linear(p["fsq_proj"], x, prec))[0] * FSQ_SCALE


def tokens(pre: torch.Tensor, levels: int = 3) -> np.ndarray:
    digits = torch.round(pre).long() + 1
    basis = levels ** torch.arange(pre.shape[-1], device=pre.device)
    return (digits * basis).sum(-1).cpu().numpy()


def mismatch_share(served, pre: torch.Tensor, margin: float) -> float:
    """The share of served tokens that differ from the reference's, over
    the positions whose every pre-rounding value lies at least `margin`
    from a rounding boundary (+-0.5); 0 when no position is clear of one."""
    served = np.asarray(served).reshape(-1)
    ref = tokens(pre)
    clear = ((pre.abs() - 0.5).abs() >= margin).all(-1).cpu().numpy()
    n = min(len(served), len(ref))
    clear = clear[:n]
    if not clear.any():
        return 0.0
    return float((served[:n][clear] != ref[:n][clear]).mean())
