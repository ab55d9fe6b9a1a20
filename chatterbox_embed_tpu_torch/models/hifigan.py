"""HiFT-GAN vocoder: NSF harmonic source + iSTFT-Net head, mel -> 24 kHz wav;
the PyTorch counterpart of `chatterbox_embed_tpu/models/hifigan.py`.

Weight norm is folded into plain convs at conversion; the n_fft=16
STFT/iSTFT pair is the matmul DFT of ops.stft; all public layouts are
channel-last. The harmonic phases and the source noise come from a draw
source (`ops.sampling.Draws` by default), so a test can feed JAX's draws.
`stream_synthesize` is the streaming window, with the phase carried from
window to window.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HiFTConfig
from ..ops import stft as stft_ops
from . import layers as L


def _down_cum(cfg: HiFTConfig):
    down_rates = [1] + list(cfg.upsample_rates[::-1][:-1])
    return [int(x) for x in np.cumprod(down_rates)[::-1]]


def _resblock_init(init, channels, kernel, dilations):
    return {
        "convs1": [L.conv1d_init(init, kernel, channels, channels) for _ in dilations],
        "convs2": [L.conv1d_init(init, kernel, channels, channels) for _ in dilations],
        "alpha1": [init.ones((channels,)) for _ in dilations],
        "alpha2": [init.ones((channels,)) for _ in dilations],
    }


def init(init: L.Init, cfg: HiFTConfig = HiFTConfig()):
    base = cfg.base_channels
    nfft = cfg.istft_n_fft
    f0p = {"convs": [L.conv1d_init(init, 3, cfg.in_channels if i == 0 else cfg.f0_cond_channels,
                                   cfg.f0_cond_channels) for i in range(5)],
           "classifier": L.linear_init(init, cfg.f0_cond_channels, 1)}
    ups, source_downs, source_resblocks, resblocks = [], [], [], []
    down_cum = _down_cum(cfg)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        ch_in, ch_out = base // (2 ** i), base // (2 ** (i + 1))
        # transposed conv: torch layout (in, out, width)
        bound = 1.0 / math.sqrt(ch_out * k)
        ups.append({"w": init.uniform((ch_in, ch_out, k), math.sqrt(3.0) * bound),
                    "b": init.zeros((ch_out,))})
        d = down_cum[i]
        source_downs.append(L.conv1d_init(init, 1 if d == 1 else d * 2, nfft + 2, ch_out))
        source_resblocks.append(_resblock_init(
            init, ch_out, cfg.source_resblock_kernel_sizes[i],
            cfg.source_resblock_dilation_sizes[i]))
        for kk, dd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            resblocks.append(_resblock_init(init, ch_out, kk, dd))
    return {
        "f0_predictor": f0p,
        "m_source_linear": L.linear_init(init, cfg.nb_harmonics + 1, 1),
        "conv_pre": L.conv1d_init(init, 7, cfg.in_channels, base),
        "ups": ups,
        "source_downs": source_downs,
        "source_resblocks": source_resblocks,
        "resblocks": resblocks,
        "conv_post": L.conv1d_init(init, 7, base // (2 ** len(cfg.upsample_rates)), nfft + 2),
    }


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------

def f0_predict(p, mel: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """mel (B, T, 80) -> f0 (B, T) Hz."""
    x = mel.to(dtype)
    for conv in p["convs"]:
        x = F.elu(L.conv1d(conv, x, padding=1, dtype=dtype))
    return torch.abs(L.linear(p["classifier"], x, dtype))[..., 0]


def sine_source(draws, f0_up: torch.Tensor, cfg: HiFTConfig = HiFTConfig()):
    """Harmonic sine source at audio rate. f0_up: (B, T_audio) upsampled f0.
    Returns the (B, nb_harmonics + 1, T_audio) excitation."""
    b, t = f0_up.shape
    nh = cfg.nb_harmonics + 1
    harmonics = torch.arange(1, nh + 1, dtype=torch.float32, device=f0_up.device)[None, :, None]
    f_mat = f0_up[:, None, :].float() * harmonics / cfg.sampling_rate     # (B, 9, T)
    # cumulative phase: an fp32 cumsum over the audio timeline, taken mod 1
    theta = 2.0 * math.pi * torch.remainder(torch.cumsum(f_mat, dim=-1), 1.0)
    phase = draws.phase((b, nh, 1)).to(f0_up.device).float().clone()
    phase[:, 0, :] = 0.0
    sines = cfg.nsf_alpha * torch.sin(theta + phase)

    uv = (f0_up > cfg.nsf_voiced_threshold).float()[:, None, :]
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    noise = noise_amp * draws.noise(tuple(sines.shape)).to(f0_up.device).float()
    return sines * uv + noise


def source_module(params, draws, f0_up: torch.Tensor, cfg: HiFTConfig = HiFTConfig()):
    """(B, T_audio) f0 -> merged excitation (B, T_audio)."""
    sines = sine_source(draws, f0_up, cfg)                 # (B, 9, T)
    merged = torch.tanh(L.linear(params["m_source_linear"], sines.transpose(1, 2)))
    return merged[..., 0]


def _resblock(p, x, kernel, dilations, dtype):
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], p["alpha1"], p["alpha2"],
                                 dilations):
        pad1 = (kernel * d - d) // 2
        h = L.snake(x, a1)
        h = L.conv1d(c1, h, padding=pad1, dilation=d, dtype=dtype)
        h = L.snake(h, a2)
        h = L.conv1d(c2, h, padding=(kernel - 1) // 2, dtype=dtype)
        x = x + h
    return x


# ---------------------------------------------------------------------------
# full vocoder
# ---------------------------------------------------------------------------

def decode(params, mel: torch.Tensor, source: torch.Tensor,
           cfg: HiFTConfig = HiFTConfig(), dtype=torch.float32) -> torch.Tensor:
    """mel (B, T, 80) + source (B, T*480) -> wav (B, T*480)."""
    win = stft_ops.hann_window(cfg.istft_n_fft)
    s_re, s_im = stft_ops.stft(source, cfg.istft_n_fft, cfg.istft_hop_len, win)
    s_stft = torch.cat([s_re, s_im], dim=1).transpose(1, 2).to(dtype)   # (B, T', 18)

    x = L.conv1d(params["conv_pre"], mel.to(dtype), padding=3, dtype=dtype)
    num_kernels = len(cfg.resblock_kernel_sizes)
    down_cum = _down_cum(cfg)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = F.leaky_relu(x, cfg.lrelu_slope)
        x = L.conv_transpose1d(params["ups"][i], x, u, (k - u) // 2, dtype=dtype)
        if i == len(cfg.upsample_rates) - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)           # ReflectionPad1d((1, 0))
        d = down_cum[i]
        si = L.conv1d(params["source_downs"][i], s_stft,
                      stride=d if d > 1 else 1, padding=d // 2 if d > 1 else 0,
                      dtype=dtype)
        si = _resblock(params["source_resblocks"][i], si,
                       cfg.source_resblock_kernel_sizes[i],
                       cfg.source_resblock_dilation_sizes[i], dtype)
        x = x + si
        acc = None
        for j in range(num_kernels):
            r = _resblock(params["resblocks"][i * num_kernels + j], x,
                          cfg.resblock_kernel_sizes[j],
                          cfg.resblock_dilation_sizes[j], dtype)
            acc = r if acc is None else acc + r
        x = acc / num_kernels
    x = F.leaky_relu(x, 0.01)
    x = L.conv1d(params["conv_post"], x, padding=3, dtype=dtype).float()

    nfreq = cfg.istft_n_fft // 2 + 1
    mag = torch.exp(x[..., :nfreq].clamp(max=float(np.log(1e2))))
    phase = torch.sin(x[..., nfreq:])                      # the reference applies sin
    real = mag * torch.cos(phase)
    imag = mag * torch.sin(phase)
    wav = stft_ops.istft(real.transpose(1, 2), imag.transpose(1, 2),
                         cfg.istft_n_fft, cfg.istft_hop_len, win)
    return wav.clamp(-cfg.audio_limit, cfg.audio_limit)


@torch.no_grad()
def inference(params, mel: torch.Tensor, draws, cfg: HiFTConfig = HiFTConfig(),
              dtype=torch.float32):
    """mel (B, T, 80) -> (wav (B, T*480), source (B, T*480))."""
    f0 = f0_predict(params["f0_predictor"], mel, dtype)    # (B, T)
    f0_up = torch.repeat_interleave(f0, cfg.total_upsample, dim=-1)
    s = source_module(params, draws, f0_up, cfg)           # (B, T*480)
    return decode(params, mel, s, cfg, dtype), s


@torch.no_grad()
def stream_synthesize(params, mel_win: torch.Tensor, draws, window: int,
                      phase_carry: torch.Tensor, carry_idx: int,
                      cfg: HiFTConfig = HiFTConfig(), dtype=torch.float32):
    """One streaming vocoder window with a phase-continuous harmonic source
    (the JAX package's stream_synthesize).

      mel_win      (B, M + new, 80): M emitted context frames, then new ones
      window       the window's index in the utterance: its source noise is
                   draws.window_noise(window, ...); the harmonic phases are
                   draws.stream_phase(...), the same in every window
      phase_carry  (B, nb_harmonics + 1) cumulative cycles at the window's
                   start (zeros for the first window)
      carry_idx    the sample at which the next window's carry is read (an
                   int, or a one-element integer tensor on the device, as
                   the stream's first chunk computes it there), clamped into
                   the window as JAX's dynamic_index clamps it
    Returns (wav (B, (M + new) * 480), the next phase_carry)."""
    b = mel_win.shape[0]
    nh = cfg.nb_harmonics + 1
    f0 = f0_predict(params["f0_predictor"], mel_win, dtype)
    up = cfg.total_upsample
    f0_up = f0[..., None].expand(*f0.shape, up).reshape(b, -1)     # repeat_interleave
    harmonics = torch.arange(1, nh + 1, dtype=torch.float32, device=mel_win.device)[None, :, None]
    f_mat = f0_up[:, None, :].float() * harmonics / cfg.sampling_rate
    rad = phase_carry.float()[:, :, None] + torch.cumsum(f_mat, dim=-1)
    if torch.is_tensor(carry_idx):
        ci = carry_idx.reshape(1).long().clamp(0, rad.shape[-1] - 1)
        carry_next = torch.remainder(rad.index_select(2, ci)[:, :, 0], 1.0)
    else:
        ci = min(max(int(carry_idx), 0), rad.shape[-1] - 1)
        carry_next = torch.remainder(rad[:, :, ci], 1.0)
    theta = 2.0 * math.pi * torch.remainder(rad, 1.0)
    phase = draws.stream_phase((b, nh, 1)).to(mel_win.device).float().clone()
    phase[:, 0, :].fill_(0.0)
    sines = cfg.nsf_alpha * torch.sin(theta + phase)
    uv = (f0_up > cfg.nsf_voiced_threshold).float()[:, None, :]
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    noise = draws.window_noise(window, tuple(sines.shape)).to(mel_win.device).float()
    sines = sines * uv + noise_amp * noise
    merged = torch.tanh(L.linear(params["m_source_linear"], sines.transpose(1, 2)))[..., 0]
    return decode(params, mel_win, merged, cfg, dtype), carry_next
