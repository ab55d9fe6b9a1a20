"""Host-side audio I/O, the port's copy of `chatterbox_embed_tpu/utils/
audio_io.py` with the wav reader and writer of its `stitching/stitcher.py`:
wav natively, other containers through the ffmpeg CLI when present."""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import wave
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import resample as resample_ops


def write_wav(path: str, audio: np.ndarray, sr: int):
    """Minimal 16-bit PCM mono wav writer."""
    pcm = np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
    pcm16 = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """16- or 32-bit PCM wav -> (mono float32, sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported wav sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def load_audio(path: str, sr: Optional[int] = None, device=None) -> Tuple[np.ndarray, int]:
    """Load any audio file -> (mono float32 numpy, sample_rate). Resamples to
    `sr` when given (librosa.load equivalent); the resampling convolution
    runs on `device` (None: the card)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        wav, file_sr = read_wav(path)
    elif ffmpeg_available():
        with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
            tmp = f.name
        try:
            subprocess.run(["ffmpeg", "-y", "-i", path, "-ac", "1", tmp],
                           check=True, capture_output=True)
            wav, file_sr = read_wav(tmp)
        finally:
            os.unlink(tmp)
    else:
        raise RuntimeError(f"cannot decode {ext} without ffmpeg; provide wav input")
    if sr is not None and sr != file_sr:
        wav = resample_ops.resample(torch.from_numpy(wav).to(resolve_device(device)),
                                    file_sr, sr).cpu().numpy()
        file_sr = sr
    return wav.astype(np.float32), file_sr


def save_audio(path: str, wav: np.ndarray, sr: int):
    write_wav(path, np.asarray(wav, np.float32).reshape(-1), sr)


def wav_to_mp3_bytes(wav: np.ndarray, sr: int, bitrate: str = "96k",
                     headroom_db: float = -0.3) -> bytes:
    """tensor -> MP3 bytes with clipping headroom (reference:
    audio/conversion.py:16-131). Requires ffmpeg; falls back to WAV bytes."""
    wav = np.clip(np.asarray(wav, np.float32).reshape(-1), -1.0, 1.0)
    peak = np.abs(wav).max()
    target = 10.0 ** (headroom_db / 20.0)
    if peak > target:
        wav = wav * (target / peak)
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        tmp_wav = f.name
    write_wav(tmp_wav, wav, sr)
    try:
        if not ffmpeg_available():
            with open(tmp_wav, "rb") as f:
                return f.read()
        tmp_mp3 = tmp_wav[:-4] + ".mp3"
        subprocess.run(["ffmpeg", "-y", "-i", tmp_wav, "-b:a", bitrate, tmp_mp3],
                       check=True, capture_output=True)
        try:
            with open(tmp_mp3, "rb") as f:
                return f.read()
        finally:
            os.unlink(tmp_mp3)
    finally:
        os.unlink(tmp_wav)
