"""RTVC-style voice encoder: 40-mel partials -> 3-layer LSTM -> 256-d speaker
embedding, the PyTorch counterpart of `chatterbox_embed_tpu/models/
voice_encoder.py`.

The JAX package writes the recurrence as a scan with the input projection
hoisted out of it; it has no Pallas kernel there, and here the three layers
go through torch's LSTM (cuDNN on the card). The parameter tree keeps the
JAX layout: "wi" (in, 4H), "wh" (H, 4H), gate order i, f, g, o, and the two
biases "bi" and "bh", which torch's LSTM also keeps apart.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from ..config import VoiceEncConfig
from ..ops import mel as mel_ops
from ..ops import resample as resample_ops
from . import layers as L


def init(init: L.Init, cfg: VoiceEncConfig = VoiceEncConfig()):
    h = cfg.ve_hidden_size
    bound = 1.0 / math.sqrt(h)
    params = {"lstm": [], "proj": L.linear_init(init, h, cfg.speaker_embed_size)}
    d_in = cfg.num_mels
    for _ in range(3):
        params["lstm"].append({
            "wi": init.uniform((d_in, 4 * h), bound),
            "wh": init.uniform((h, 4 * h), bound),
            "bi": init.uniform((4 * h,), bound),
            "bh": init.uniform((4 * h,), bound),
        })
        d_in = h
    return params


@torch.no_grad()
def forward(params, mels: torch.Tensor, cfg: VoiceEncConfig = VoiceEncConfig()):
    """mels: (B, T=160, M=40) unscaled mel partials -> (B, 256) L2-normed."""
    x = mels.float()
    flat = []
    for p in params["lstm"]:
        # torch keeps weight_ih (4H, in) and weight_hh (4H, H)
        flat += [p["wi"].float().t().contiguous(), p["wh"].float().t().contiguous(),
                 p["bi"].float(), p["bh"].float()]
    h_dim = params["lstm"][0]["wh"].shape[0]
    n = len(params["lstm"])
    zeros = torch.zeros((n, x.shape[0], h_dim), dtype=x.dtype, device=x.device)
    _out, h_n, _c = torch.lstm(x, (zeros, zeros), flat, True, n, 0.0, False, False, True)
    emb = L.linear(params["proj"], h_n[-1])
    if cfg.ve_final_relu:
        emb = torch.relu(emb)
    return emb / torch.linalg.norm(emb, dim=1, keepdim=True)


# ---------------------------------------------------------------------------
# utterance-level embedding (partials -> mean -> L2 norm)
# ---------------------------------------------------------------------------

def _frame_step(cfg: VoiceEncConfig, overlap=0.5, rate: float | None = None) -> int:
    if rate is None:
        return int(round(cfg.ve_partial_frames * (1 - overlap)))
    return int(round((cfg.sample_rate / rate) / cfg.ve_partial_frames))


def _num_wins(n_frames: int, step: int, min_coverage: float, cfg: VoiceEncConfig):
    win = cfg.ve_partial_frames
    n_wins, rem = divmod(max(n_frames - win + step, 0), step)
    if n_wins == 0 or (rem + (win - step)) / win >= min_coverage:
        n_wins += 1
    return n_wins, win + step * (n_wins - 1)


@torch.no_grad()
def embed_utterance(params, mel_tm: torch.Tensor, cfg: VoiceEncConfig = VoiceEncConfig(),
                    overlap=0.5, rate: float | None = 1.3, min_coverage=0.8):
    """mel_tm: (T, M) unscaled mel of one utterance -> (256,) fp32 tensor."""
    step = _frame_step(cfg, overlap, rate)
    n_frames = int(mel_tm.shape[0])
    n_wins, target = _num_wins(n_frames, step, min_coverage, cfg)
    mel = mel_tm.float()
    if target > n_frames:
        mel = torch.nn.functional.pad(mel, (0, 0, 0, target - n_frames))
    else:
        mel = mel[:target]
    partials = mel.unfold(0, cfg.ve_partial_frames, step)[:n_wins]   # (N, 40, 160)
    embeds = forward(params, partials.transpose(1, 2), cfg)          # (N, 256)
    spk = embeds.mean(dim=0)
    return spk / torch.linalg.norm(spk)


@torch.no_grad()
def embeds_from_wavs(params, wavs: List[np.ndarray], sample_rate: int,
                     cfg: VoiceEncConfig = VoiceEncConfig(), trim_top_db: float = 20.0,
                     rate: float = 1.3) -> np.ndarray:
    """Utterance embeddings, one per wav, (N, 256) numpy. Resampling, mel and
    the LSTM run on the device of `params`; silence trimming
    (librosa.effects.trim(top_db=20) semantics) on the host."""
    dev = params["proj"]["w"].device
    out = []
    for w in wavs:
        w = np.asarray(w, np.float32)
        if sample_rate != cfg.sample_rate:
            w = resample_ops.resample(torch.from_numpy(w).to(dev), sample_rate,
                                      cfg.sample_rate).cpu().numpy()
        if trim_top_db is not None:
            w = trim_silence(w, top_db=trim_top_db)
        mel = mel_ops.melspectrogram_ve(torch.from_numpy(np.ascontiguousarray(w)).to(dev)).T
        out.append(embed_utterance(params, mel, cfg, rate=rate).cpu().numpy())
    return np.stack(out)


def trim_silence(wav: np.ndarray, top_db: float = 20.0, frame_length: int = 2048,
                 hop_length: int = 512) -> np.ndarray:
    """librosa.effects.trim-equivalent leading/trailing silence removal."""
    if wav.shape[0] < frame_length:
        return wav
    n = 1 + (wav.shape[0] - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(np.square(wav[idx]), axis=1))
    ref = rms.max()
    if ref <= 0:
        return wav
    keep = 20.0 * np.log10(np.maximum(rms, 1e-10) / ref) > -top_db
    if not keep.any():
        return wav[:0]
    first, last = np.argmax(keep), n - 1 - np.argmax(keep[::-1])
    start = first * hop_length
    end = min(wav.shape[0], last * hop_length + frame_length)
    return wav[start:end]
