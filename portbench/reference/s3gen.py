"""S3Gen, Chatterbox's token-to-waveform decoder, for one row: the
upsampling conformer, the conditional flow-matching solver over its U-Net
estimator, and the HiFT vocoder.

What a served row was computed from is rebuilt here, as the serving path
lays it out: the voice prompt's tokens padded to `p_width`, the generated
tokens padded to `width` (both a bucket the program chose for the whole
dispatch), the CFM noise the first frames of a fixed Philox buffer, and
with `cache_every` >= 2 the DeepCache schedule of the batched solver (the
mid stack recomputed on steps that are a multiple of it and on the last).
The relative-position attention is the Transformer-XL form over a table
of relative positions; the STFT pair is torch.stft / torch.istft.

`cfg` is the configuration file's "s3gen" dict.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import nn
from .nn import FP32, Prec

SAMPLES_PER_FRAME = 480


@lru_cache(maxsize=2)
def fixed_noise(n_feats: int = 80, frames: int = 50 * 300) -> np.ndarray:
    """The CFM's starting noise: one Philox(54321) buffer (1, frames, 80)."""
    g = np.random.Generator(np.random.Philox(54321))
    return g.standard_normal(size=(1, frames, n_feats), dtype=np.float32)


# --------------------------------------------------------------------- conformer

def _rel_pe(t: int, d: int, device) -> torch.Tensor:
    """(2t - 1, d) sinusoids of the relative positions t-1 ... -(t-1): even
    columns sin, odd cos, at the espnet frequencies."""
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32) * -(math.log(10_000.0) / d))
    rel = torch.arange(t - 1, -t, -1, dtype=torch.float32)[:, None] * div
    pe = torch.zeros((2 * t - 1, d))
    pe[:, 0::2], pe[:, 1::2] = torch.sin(rel), torch.cos(rel)
    return pe.to(device)


def _rel_attention(p, x, valid, n_heads, prec):
    b, t, d = x.shape
    dk = d // n_heads
    q = nn.heads(nn.linear(p["q"], x, prec), n_heads)
    k = nn.heads(nn.linear(p["k"], x, prec), n_heads)
    v = nn.heads(nn.linear(p["v"], x, prec), n_heads)
    pos = nn.heads(nn.linear(p["pos"], _rel_pe(t, d, x.device)[None], prec), n_heads)[0]
    ac = torch.einsum("bihc,bjhc->bhij", q + p["pos_bias_u"].float(), k)
    bd_all = torch.einsum("bihc,rhc->bhir", q + p["pos_bias_v"].float(), pos)
    i = torch.arange(t, device=x.device)
    idx = (t - 1) - i[:, None] + i[None, :]              # row of relative position i - j
    bd = bd_all.gather(-1, idx[None, None].expand(b, n_heads, t, t))
    s = (ac + bd) / math.sqrt(dk)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    out = torch.einsum("bhij,bjhc->bihc", torch.softmax(s, dim=-1), v)
    return nn.linear(p["o"], nn.merge(out), prec)


def _conformer_blocks(blocks, h, valid, cfg, prec):
    for p in blocks:
        h = h + _rel_attention(p, nn.layer_norm(p["norm_mha"], h, cfg["ln_eps"]), valid,
                               cfg["attention_heads"], prec)
        a = nn.layer_norm(p["norm_ff"], h, cfg["ln_eps"])
        h = h + nn.linear(p["ff2"], F.silu(nn.linear(p["ff1"], a, prec)), prec)
    return h


def conformer(p, x, n_valid: int, cfg: dict, prec: Prec = FP32):
    """(1, T, 512) embedded tokens, the first n_valid real -> (1, 2T, 512)."""
    t = x.shape[1]
    dev = x.device
    valid = torch.arange(t, device=dev)[None] < n_valid
    xs = math.sqrt(cfg["output_size"])
    h = nn.layer_norm(p["embed"]["ln"], nn.linear(p["embed"]["lin"], x, prec),
                      cfg["embed_ln_eps"]) * xs * valid[..., None]
    la = p["lookahead"]
    y = F.leaky_relu(nn.conv1d(la["conv1"], h, prec, padding=(0, cfg["pre_lookahead_len"])),
                     0.01)
    h = h + nn.conv1d(la["conv2"], y, prec, padding=(2, 0))
    h = _conformer_blocks(p["blocks"], h, valid, cfg, prec)
    s = cfg["upsample_stride"]
    h = torch.repeat_interleave(h, s, dim=1)
    h = nn.conv1d(p["up_conv"], h, prec, padding=(2 * s, 0))
    valid2 = torch.arange(h.shape[1], device=dev)[None] < n_valid * s
    h = nn.layer_norm(p["up_embed"]["ln"], nn.linear(p["up_embed"]["lin"], h, prec),
                      cfg["embed_ln_eps"]) * xs * valid2[..., None]
    h = _conformer_blocks(p["up_blocks"], h, valid2, cfg, prec)
    return nn.layer_norm(p["after_norm"], h, cfg["embed_ln_eps"])


# --------------------------------------------------------------------- estimator

def _causal_block(p, x, mask, prec):
    h = nn.conv1d(p["conv"], x * mask, prec, padding=(2, 0))
    return nn.mish(nn.layer_norm(p["ln"], h)) * mask


def _resnet(p, x, mask, t_emb, prec):
    h = _causal_block(p["block1"], x, mask, prec)
    h = h + nn.linear(p["mlp"], nn.mish(t_emb), prec)[:, None, :]
    h = _causal_block(p["block2"], h, mask, prec)
    return h + nn.conv1d(p["res_conv"], x * mask, prec)


def _stage(p, x, mask, valid, t_emb, n_heads, prec):
    x = _resnet(p["resnet"], x, mask, t_emb, prec)
    for tb in p["tblocks"]:
        a = nn.layer_norm(tb["ln1"], x)
        q, k, v = (nn.heads(nn.linear(tb[n], a, prec), n_heads) for n in ("q", "k", "v"))
        x = x + nn.linear(tb["o"], nn.merge(nn.attention(q, k, v, key_valid=valid)), prec)
        a = nn.layer_norm(tb["ln3"], x)
        x = x + nn.linear(tb["ff2"], F.gelu(nn.linear(tb["ff1"], a, prec)), prec)
    return x


def estimator(p, x, mu, t, spks, cond, mask, cfg: dict, prec: Prec = FP32, mid=None):
    """The U-Net's velocity (B, T, 80); `mid`: the mid stack's output of an
    earlier step to reuse. Returns (velocity, the mid output used)."""
    b, tlen, _ = x.shape
    valid = mask[..., 0] > 0
    half = cfg["in_channels"] // 2
    freqs = torch.exp(-math.log(10_000) * torch.arange(half, device=x.device) / (half - 1))
    ang = 1000.0 * t[:, None] * freqs[None]
    t_emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    tm = p["time_mlp"]
    t_emb = nn.linear(tm["lin2"], F.silu(nn.linear(tm["lin1"], t_emb, prec)), prec)
    h = torch.cat([x, mu, spks[:, None].expand(b, tlen, spks.shape[-1]), cond], dim=-1)
    nh = cfg["num_heads"]
    h = _stage(p["down"], h, mask, valid, t_emb, nh, prec)
    skip = h
    if mid is None:
        h = nn.conv1d(p["down"]["downsample"], h * mask, prec, padding=(2, 0))
        for st in p["mid"]:
            h = _stage(st, h, mask, valid, t_emb, nh, prec)
        mid = h
    h = _stage(p["up"], torch.cat([mid, skip], dim=-1), mask, valid, t_emb, nh, prec)
    h = nn.conv1d(p["up"]["upsample"], h * mask, prec, padding=(2, 0))
    h = _causal_block(p["final_block"], h, mask, prec)
    return nn.conv1d(p["final_proj"], h * mask, prec) * mask, mid


def solve(p, mu, spks, cond, mask, cfm: dict, dec: dict, prec: Prec = FP32,
          cache_every: int = 0):
    """Euler steps on a cosine schedule from the fixed noise, classifier-
    free guidance on every step (the unconditional row zeroes mu, spks and
    cond)."""
    tlen = mu.shape[1]
    x = torch.from_numpy(fixed_noise(mu.shape[-1])[:, :tlen].copy()).to(mu.device)
    n = cfm["n_timesteps"]
    ts = np.linspace(0.0, 1.0, n + 1, dtype=np.float32)
    t_span = (1.0 - np.cos(ts * 0.5 * np.pi)).astype(np.float32)
    w = cfm["inference_cfg_rate"]
    pair = lambda a: torch.cat([a, torch.zeros_like(a)])
    mu2, spks2, cond2, mask2 = pair(mu), pair(spks), pair(cond), torch.cat([mask, mask])
    mid = None
    for i in range(n):
        reuse = cache_every >= 2 and n > 2 and i % cache_every != 0 and i != n - 1
        tt = torch.full((2,), float(t_span[i]), device=mu.device)
        v, m = estimator(p, torch.cat([x, x]), mu2, tt, spks2, cond2, mask2, dec, prec,
                         mid=mid if reuse else None)
        mid = m
        x = x + float(t_span[i + 1] - t_span[i]) * ((1.0 + w) * v[:1] - w * v[1:])
    return x


def flow(p, tokens, prompt: dict, width: int, p_width: int, cfg: dict, prec: Prec = FP32,
         cache_every: int = 0):
    """Mel (2 * width, 80) of the generated part: the prompt's p tokens
    padded to p_width, then the n tokens padded to width."""
    fl = p["flow"]
    dev = fl["input_embedding"]["w"].device
    pt = np.asarray(prompt["prompt_token"]).reshape(-1)
    n_p, n = pt.shape[0], len(tokens)
    full = np.zeros(p_width + width, np.int64)
    full[:n_p], full[n_p:n_p + n] = pt, np.asarray(tokens)
    n_valid = n_p + n
    full_t = torch.from_numpy(full).to(dev)
    x = fl["input_embedding"]["w"][full_t][None].float()
    x = x * (torch.arange(full.shape[0], device=dev) < n_valid)[None, :, None]
    fcfg = cfg["flow"]
    h = nn.linear(fl["encoder_proj"], conformer(fl["encoder"], x, n_valid, fcfg["encoder"],
                                                prec), prec)
    emb = torch.as_tensor(np.asarray(prompt["embedding"]), dtype=torch.float32,
                          device=dev).reshape(1, -1)
    spks = nn.linear(fl["spk_embed_affine"], emb / emb.norm(dim=-1, keepdim=True), prec)
    r = fcfg["token_mel_ratio"]
    cond = torch.zeros_like(h)
    feat = torch.as_tensor(np.asarray(prompt["prompt_feat"]), dtype=torch.float32,
                           device=dev).reshape(-1, h.shape[-1])
    cond[0, : r * n_p] = feat[: r * n_p]
    mask = (torch.arange(h.shape[1], device=dev) < r * n_valid).float()[None, :, None]
    mel = solve(fl["decoder"], h, spks, cond, mask, fcfg["cfm"], fcfg["decoder"], prec,
                cache_every)
    return mel[0, r * n_p: r * n_p + r * width]


# --------------------------------------------------------------------- HiFT

def _down_cum(rates):
    down = [1] + list(rates[::-1][:-1])
    return [int(x) for x in np.cumprod(down)[::-1]]


def _resblock(p, x, kernel, dilations, prec):
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], p["alpha1"], p["alpha2"],
                                 dilations):
        h = nn.conv1d(c1, nn.snake(x, a1), prec, padding=(kernel * d - d) // 2, dilation=d)
        x = x + nn.conv1d(c2, nn.snake(h, a2), prec, padding=(kernel - 1) // 2)
    return x


def hift(p, mel, phase, noise, cfg: dict, prec: Prec = FP32):
    """mel (T, 80) -> wav (T * 480). phase (9,): the harmonics' start
    phases (the first is set to 0); noise (9, T * 480) standard normal."""
    mel = mel[None].float()
    x = mel
    for conv in p["f0_predictor"]["convs"]:
        x = F.elu(nn.conv1d(conv, x, prec, padding=1))
    f0 = torch.abs(nn.linear(p["f0_predictor"]["classifier"], x, prec))[0, :, 0]
    f0_up = torch.repeat_interleave(f0, SAMPLES_PER_FRAME)           # (Ta,)
    nh = cfg["nb_harmonics"] + 1
    harm = torch.arange(1, nh + 1, dtype=torch.float32, device=mel.device)[:, None]
    theta = 2 * math.pi * torch.remainder(torch.cumsum(f0_up[None] * harm / cfg["sampling_rate"],
                                                       dim=-1), 1.0)
    ph = phase.float().reshape(nh, 1).clone()
    ph[0] = 0.0
    uv = (f0_up > cfg["nsf_voiced_threshold"]).float()[None]
    amp = uv * cfg["nsf_sigma"] + (1 - uv) * cfg["nsf_alpha"] / 3
    sines = cfg["nsf_alpha"] * torch.sin(theta + ph) * uv + amp * noise.float()
    src = torch.tanh(nn.linear(p["m_source_linear"], sines.T[None], prec))[0, :, 0]
    return decode(p, mel[0], src, cfg, prec)


def decode(p, mel, src, cfg: dict, prec: Prec = FP32):
    """HiFT's decoder: mel (T, 80) and the merged source (T * 480,) ->
    wav (T * 480,), clamped to the audio limit."""
    mel = mel[None].float()
    n_fft, hop = cfg["istft_n_fft"], cfg["istft_hop_len"]
    win = torch.hann_window(n_fft, device=mel.device)
    spec = torch.stft(src[None], n_fft, hop, window=win, center=True, pad_mode="reflect",
                      return_complex=True)[0]                          # (9, T')
    s_stft = torch.cat([spec.real, spec.imag], dim=0).T[None]         # (1, T', 18)

    x = nn.conv1d(p["conv_pre"], mel, prec, padding=3)
    rates, kernels = cfg["upsample_rates"], cfg["upsample_kernel_sizes"]
    nk = len(cfg["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(rates, kernels)):
        x = nn.conv_transpose1d(p["ups"][i], F.leaky_relu(x, cfg["lrelu_slope"]), prec, u,
                                (k - u) // 2)
        if i == len(rates) - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)
        d = _down_cum(rates)[i]
        si = nn.conv1d(p["source_downs"][i], s_stft, prec, stride=d,
                       padding=d // 2 if d > 1 else 0)
        x = x + _resblock(p["source_resblocks"][i], si, cfg["source_resblock_kernel_sizes"][i],
                          cfg["source_resblock_dilation_sizes"][i], prec)
        x = sum(_resblock(p["resblocks"][i * nk + j], x, cfg["resblock_kernel_sizes"][j],
                          cfg["resblock_dilation_sizes"][j], prec) for j in range(nk)) / nk
    x = nn.conv1d(p["conv_post"], F.leaky_relu(x, 0.01), prec, padding=3)[0]
    nf = n_fft // 2 + 1
    mag = torch.exp(x[:, :nf].clamp(max=math.log(1e2)))
    phs = torch.sin(x[:, nf:])
    wav = torch.istft(torch.complex(mag * torch.cos(phs), mag * torch.sin(phs)).T, n_fft, hop,
                      window=win, center=True)
    return wav.clamp(-cfg["audio_limit"], cfg["audio_limit"])


def trim_fade(sr: int) -> torch.Tensor:
    n = sr // 50
    fade = torch.zeros(2 * n)
    fade[n:] = (torch.cos(torch.linspace(math.pi, 0.0, n)) + 1.0) / 2.0
    return fade


def vocode(p, mel, n_tokens: int, phase, noise, cfg: dict, prec: Prec = FP32) -> np.ndarray:
    """A served row's wav from its mel (2 * width, 80): HiFT, the trim fade,
    cut to (2 * n_tokens * 480,) fp32 numpy."""
    mel = torch.as_tensor(mel, dtype=torch.float32, device=phase.device)
    wav = hift(p["hift"], mel, phase, noise[:, : mel.shape[0] * SAMPLES_PER_FRAME], cfg["hift"],
               prec)
    fade = trim_fade(cfg["hift"]["sampling_rate"]).to(wav.device)
    wav[: fade.shape[0]] *= fade
    return wav[: 2 * n_tokens * SAMPLES_PER_FRAME].cpu().numpy()
