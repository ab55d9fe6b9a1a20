"""Audio watermarking, the port's copy of `chatterbox_embed_tpu/utils/
watermark.py` (a host-side numpy call outside the device path).

When `perth` (resemble-perth) is importable it is used. Otherwise a built-in
implicit watermarker: a seeded pseudo-random +-1 chip sequence spread over a
4-8 kHz band at -36 dB relative to signal energy, detectable by matched
filtering. Same call signature as Perth.
"""
from __future__ import annotations

import numpy as np

_CHIP_SEED = 0x5EED
_BAND = (4000.0, 8000.0)
_STRENGTH_DB = -36.0
_FRAME = 1024


def _chip_sequence(n: int) -> np.ndarray:
    rng = np.random.default_rng(_CHIP_SEED)
    return rng.choice([-1.0, 1.0], size=n).astype(np.float32)


def _carrier_spec(n: int, sr: int):
    """Deterministic band-limited carrier phases: (band mask, unit spec)."""
    rng = np.random.default_rng(_CHIP_SEED + 1)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    band = (freqs >= _BAND[0]) & (freqs <= min(_BAND[1], sr / 2 * 0.95))
    phases = rng.uniform(0, 2 * np.pi, band.sum())
    return band, np.exp(1j * phases)


def _bandpass_noise(n: int, sr: int) -> np.ndarray:
    """Deterministic band-limited carrier (time domain)."""
    band, unit = _carrier_spec(n, sr)
    spec = np.zeros(n // 2 + 1, np.complex128)
    spec[band] = unit
    x = np.fft.irfft(spec, n)
    return (x / (np.abs(x).max() + 1e-12)).astype(np.float32)


class ImplicitWatermarker:
    """Fallback spread-spectrum watermarker with Perth's interface."""

    def apply_watermark(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        flat = wav.reshape(-1)
        n_frames = len(flat) // _FRAME
        if n_frames == 0:
            return wav
        chips = _chip_sequence(n_frames)
        carrier = _bandpass_noise(_FRAME, sample_rate)
        gain = 10.0 ** (_STRENGTH_DB / 20.0)
        out = flat.copy()
        seg = out[: n_frames * _FRAME].reshape(n_frames, _FRAME)
        # scale to local energy so the mark stays inaudible in quiet parts
        local_rms = np.sqrt(np.mean(seg ** 2, axis=1, keepdims=True)) + 1e-8
        seg += chips[:, None] * carrier[None, :] * local_rms * gain
        out[: n_frames * _FRAME] = seg.reshape(-1)
        return np.clip(out, -1.0, 1.0).reshape(wav.shape)

    def get_watermark(self, wav: np.ndarray, sample_rate: int) -> float:
        """Detection score in [0, 1]: normalised correlation between the
        per-frame detector outputs and the chip sequence (≈1.0 for marked
        audio, ≈0.0 for clean).

        The per-frame statistic is a SOFT-LIMITED matched filter in the
        carrier band: bin magnitudes are capped at 3x the frame's median
        band magnitude before correlating with the carrier phases. A plain
        matched filter is swamped by narrowband in-band content (music
        harmonics between 4-8 kHz); the cap bounds any single bin's
        influence while keeping the broadband matched-filter gain."""
        flat = np.asarray(wav, np.float32).reshape(-1)
        n_frames = len(flat) // _FRAME
        if n_frames < 8:
            return 0.0
        chips = _chip_sequence(n_frames)
        band, unit = _carrier_spec(_FRAME, sample_rate)
        seg = flat[: n_frames * _FRAME].reshape(n_frames, _FRAME)
        # Hann window: without it, the spectral leakage of any strong
        # out-of-band tone (plain speech harmonics) swamps the band bins
        win = np.hanning(_FRAME).astype(np.float32)
        spec = np.fft.rfft(seg * win, axis=1)[:, band]
        mag = np.abs(spec)
        cap = 3.0 * np.median(mag, axis=1, keepdims=True) + 1e-12
        limited = spec * np.minimum(1.0, cap / (mag + 1e-12))
        corr = (limited @ np.conj(unit)).real          # (n_frames,)
        corr = corr / (np.linalg.norm(limited, axis=1) + 1e-12)
        corr = corr - corr.mean()
        denom = np.linalg.norm(corr) * np.linalg.norm(chips)
        if denom == 0:
            return 0.0
        return float(max(0.0, np.dot(corr, chips) / denom))


def get_watermarker():
    try:
        import perth  # type: ignore
        return perth.PerthImplicitWatermarker()
    except Exception:
        return ImplicitWatermarker()
