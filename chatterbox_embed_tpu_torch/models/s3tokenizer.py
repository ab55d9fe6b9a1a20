"""S3 speech tokenizer v2 (25 Hz): 16 kHz wav -> discrete speech tokens, the
PyTorch counterpart of `chatterbox_embed_tpu/models/s3tokenizer.py`.

- frontend: two Conv1d(k=3, stride=2) + GELU over 128-bin log-mels,
  100 Hz mel frames -> 25 Hz token frames;
- encoder: residual blocks of FSMN multi-head attention (softmax attention
  plus a depthwise-conv memory branch, kernel 31, over the value
  projection) followed by a GELU MLP (x4);
- head: FSQ, Linear(n_state -> 8), tanh, scale 0.999..., round to {-1,0,1},
  +1, base-3 positional encode -> 3**8 = 6561 codes.

Callers pad waveforms to 40 ms multiples; padded frames are masked before
each conv and inside the FSMN branch, so the tokens do not depend on the
padding. The tokens are a rounding: two correct fp32 implementations agree
except where a pre-rounding value lies on a rounding boundary.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import EOS, S3_SR, S3_TOKEN_RATE, SOS, S3TokenizerConfig
from ..device import full_fp32
from ..ops import mel as mel_ops
from . import layers as L

# The reference rounds tanh(z) * this constant (the fp32 image of 0.999)
# before the base-3 encode; kept bit-equal so converted checkpoints match.
_FSQ_SCALE = 0.9990000128746033


def init(init: L.Init, cfg: S3TokenizerConfig = S3TokenizerConfig()):
    d = cfg.n_state
    params = {
        "conv1": L.conv1d_init(init, 3, cfg.n_mels, d),
        "conv2": L.conv1d_init(init, 3, d, d),
        "blocks": [],
        "fsq_proj": L.linear_init(init, d, cfg.fsq_dim),
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "ln1": L.layer_norm_init(init, d),
            "q": L.linear_init(init, d, d),
            "k": L.linear_init(init, d, d, bias=False),
            "v": L.linear_init(init, d, d),
            "o": L.linear_init(init, d, d),
            "fsmn": L.conv1d_init(init, cfg.fsmn_kernel, d, d, bias=False, groups=d),
            "ln2": L.layer_norm_init(init, d),
            "fc1": L.linear_init(init, d, 4 * d),
            "fc2": L.linear_init(init, 4 * d, d),
        })
    return params


def _fsmn(p, v, mask_pad, kernel: int, dtype):
    """The memory branch: depthwise conv (symmetric pad) + residual over the
    value projection, masked on both sides of the conv."""
    x = v * mask_pad
    lo = (kernel - 1) // 2
    y = L.conv1d(p, x, padding=(lo, kernel - 1 - lo), groups=x.shape[-1], dtype=dtype)
    return (y + x) * mask_pad


def _block(p, x, attn_mask, mask_pad, cfg: S3TokenizerConfig, dtype):
    # the reference's asymmetry kept: attn_ln eps=1e-6, mlp_ln default 1e-5
    h = L.layer_norm(p["ln1"], x, eps=1e-6)
    q = L.split_heads(L.linear(p["q"], h, dtype), cfg.n_heads)
    k = L.split_heads(L.linear(p["k"], h, dtype), cfg.n_heads)
    v = L.linear(p["v"], h, dtype)
    mem = _fsmn(p["fsmn"], v, mask_pad, cfg.fsmn_kernel, dtype)
    att = L.merge_heads(L.mha(q, k, L.split_heads(v, cfg.n_heads), mask=attn_mask))
    x = x + L.linear(p["o"], att, dtype) + mem
    h = L.layer_norm(p["ln2"], x)
    return x + L.linear(p["fc2"], F.gelu(L.linear(p["fc1"], h, dtype)), dtype)


@torch.no_grad()
def encode(params, mels: torch.Tensor, mel_lens: torch.Tensor,
           cfg: S3TokenizerConfig = S3TokenizerConfig(), dtype=torch.float32):
    """mels (B, n_mels, T@100Hz) -> hidden (B, ceil(T/4), n_state), token lens.

    Padded frames are zeroed before each strided conv (kernel 3 reads one
    frame across the length boundary), so outputs do not depend on padding.
    The two front-end GELUs are the tanh approximation, as the JAX package
    computes them (jax.nn.gelu's default); the blocks' MLP GELU is exact.
    """
    with full_fp32():
        dev = mels.device
        mel_lens = mel_lens.to(dev)
        x = mels.transpose(1, 2).to(dtype)                          # (B, T, 128)

        def valid(t, lens):
            return (torch.arange(t, device=dev)[None, :] < lens[:, None])

        x = x * valid(x.shape[1], mel_lens)[..., None].to(x.dtype)
        x = F.gelu(L.conv1d(params["conv1"], x, stride=2, padding=1, dtype=dtype),
                   approximate="tanh")
        l1 = (mel_lens + 1) // 2
        x = x * valid(x.shape[1], l1)[..., None].to(x.dtype)
        x = F.gelu(L.conv1d(params["conv2"], x, stride=2, padding=1, dtype=dtype),
                   approximate="tanh")
        tok_lens = (l1 + 1) // 2
        pad_mask = valid(x.shape[1], tok_lens)                      # (B, T)
        attn_mask = pad_mask[:, None, None, :]                      # (B, 1, 1, Tk)
        mask_pad = pad_mask[:, :, None].to(x.dtype)                 # (B, T, 1)
        for blk in params["blocks"]:
            x = _block(blk, x, attn_mask, mask_pad, cfg, dtype)
        return x, tok_lens


def fsq_pre_round(params, h: torch.Tensor) -> torch.Tensor:
    """The values that `fsq_quantize` rounds: tanh(proj(h)) * 0.999...,
    (B, T, fsq_dim) fp32. Rounding boundaries lie at +-0.5."""
    with full_fp32():
        z = L.linear(params["fsq_proj"], h.float())
    return torch.tanh(z) * _FSQ_SCALE


def fsq_quantize(params, h: torch.Tensor, cfg: S3TokenizerConfig = S3TokenizerConfig()):
    """Finite scalar quantization: (B, T, n_state) -> int64 token ids (B, T).

    8 dims x 3 levels: digit_i = round(tanh(z_i) * 0.999...) + 1 in {0,1,2},
    index = sum_i digit_i * 3^i. torch.round rounds halves to even, as
    jnp.round does.
    """
    digits = torch.round(fsq_pre_round(params, h)).long() + 1
    basis = torch.from_numpy((cfg.fsq_levels ** np.arange(cfg.fsq_dim)).astype(np.int64))
    return (digits * basis.to(digits.device)).sum(dim=-1)


@torch.no_grad()
def quantize(params, mels: torch.Tensor, mel_lens: torch.Tensor,
             cfg: S3TokenizerConfig = S3TokenizerConfig(), dtype=torch.float32):
    """mels -> (tokens (B, T_tok) int64, lens (B,))."""
    h, tok_lens = encode(params, mels, mel_lens, cfg, dtype)
    return fsq_quantize(params, h, cfg), tok_lens


def pad_to_token_multiple(wav: np.ndarray, sr: int = S3_SR) -> np.ndarray:
    """Zero-pad so the duration is a whole number of 40 ms tokens."""
    n_tokens = int(np.ceil(wav.shape[-1] / sr * S3_TOKEN_RATE))
    target = int(n_tokens * (sr / S3_TOKEN_RATE))
    if target > wav.shape[-1]:
        pad = [(0, 0)] * (wav.ndim - 1) + [(0, target - wav.shape[-1])]
        wav = np.pad(wav, pad)
    return wav


@torch.no_grad()
def tokenize_wave(params, wav_16k: torch.Tensor, max_len: int | None = None,
                  cfg: S3TokenizerConfig = S3TokenizerConfig(), dtype=torch.float32):
    """wav_16k (B, T) -> (tokens (B, T_tok), lens (B,)). Mel frames are cut to
    4*max_len when a token cap is given."""
    mels = mel_ops.log_mel_s3tokenizer(wav_16k, n_fft=cfg.n_fft, hop=cfg.hop,
                                       n_mels=cfg.n_mels)
    if max_len is not None:
        mels = mels[..., : max_len * 4]
    mel_lens = torch.full((mels.shape[0],), mels.shape[-1], dtype=torch.int64,
                          device=mels.device)
    return quantize(params, mels, mel_lens, cfg, dtype)


def drop_invalid_tokens(tokens: np.ndarray) -> np.ndarray:
    """The ids of a 1-D sequence after its first SOS (from the start if none)
    and before its first EOS (to the end if none): the first step of
    cleaning T3's tokens, as the JAX package's s3tokenizer.drop_invalid_tokens;
    s3gen.drop_invalid_tokens (ids < 6561) is the second."""
    tokens = np.asarray(tokens).reshape(-1)
    sos = np.nonzero(tokens == SOS)[0]
    eos = np.nonzero(tokens == EOS)[0]
    start = int(sos[0]) + 1 if sos.size else 0
    end = int(eos[0]) if eos.size else tokens.shape[0]
    return tokens[start:end]
