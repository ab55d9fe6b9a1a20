"""The port's copy of `chatterbox_embed_tpu/stitching/stitcher.py`, which imports no
jax. Chunk stitching: smart pauses, hot-start-aware fades, peak normalisation
with -0.5 dBFS headroom (reference behaviors: stitching/advanced_stitcher.py:
20-312). Pure numpy — no pydub/ffmpeg dependency on the synthesis path."""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..chunking.types import ChunkInfo, ContentType
from ..utils.audio_io import read_wav, write_wav  # noqa: F401  (one copy of each)

logger = logging.getLogger(__name__)


def _dbfs(x: np.ndarray) -> float:
    """RMS level in dBFS (mirrors pydub's AudioSegment.dBFS for float audio)."""
    if x.size == 0:
        return -np.inf
    rms = np.sqrt(np.mean(np.square(x, dtype=np.float64)))
    return 20.0 * np.log10(rms) if rms > 0 else -np.inf


def _fade(x: np.ndarray, n: int, direction: str) -> np.ndarray:
    """Linear amplitude ramp over n samples at the head or tail."""
    n = min(n, len(x))
    if n <= 0:
        return x
    ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
    y = x.copy()
    if direction == "in":
        y[:n] *= ramp
    else:
        y[-n:] *= ramp[::-1]
    return y


class AdvancedStitcher:
    def __init__(self, sample_rate: int = 24_000):
        self.sr = sample_rate
        self.fade_in_duration = 90        # ms
        self.fade_out_duration = 70       # ms
        self.fade_in_first_chunk_ms = 130
        self.global_pause_factor = 1.2
        self.extra_first_pause_ms = 60
        self.headroom_dbfs = -0.5

    # -- pauses (reference: calculate_smart_pause, stitcher:61-80) -----------

    def calculate_smart_pause(self, info: ChunkInfo,
                              next_info: Optional[ChunkInfo] = None) -> int:
        base = 600 if (info.has_story_break or info.paragraph_break_after) else 250
        pause = base * max(0.5, min(2.0, self.global_pause_factor))
        if info.is_first_chunk:
            pause += max(0, int(self.extra_first_pause_ms))
        return int(max(120, min(900, pause)))

    # -- fades (reference: apply_smart_fades, stitcher:82-136) ---------------

    def apply_smart_fades(self, seg: np.ndarray, is_first: bool, is_last: bool,
                          prev_info: Optional[ChunkInfo] = None,
                          next_info: Optional[ChunkInfo] = None) -> np.ndarray:
        ms = self.sr // 1000
        head_hot = _dbfs(seg[:60 * ms]) > -35.0
        tail_hot = _dbfs(seg[-60 * ms:]) > -35.0

        if is_first:
            fade_in = self.fade_in_first_chunk_ms
        else:
            fade_in = self.fade_in_duration
            if head_hot:  # protect initial consonants
                fade_in = min(fade_in, 20)
            if prev_info and prev_info.content_type == ContentType.DIALOGUE:
                fade_in = int(fade_in * 1.2)
        seg = _fade(seg, fade_in * ms, "in")

        if not is_last:
            fade_out = self.fade_out_duration
            if tail_hot:
                fade_out = min(fade_out, 25)
            if next_info and next_info.content_type == ContentType.DIALOGUE:
                fade_out = int(fade_out * 1.2)
            seg = _fade(seg, fade_out * ms, "out")
        return seg

    # -- main entry (reference: advanced_stitch, stitcher:173-283) -----------

    def advanced_stitch(self, segments: Sequence[np.ndarray],
                        chunk_infos: Sequence[ChunkInfo],
                        output_path: Optional[str] = None
                        ) -> Tuple[np.ndarray, int, float]:
        """Stitch chunk waveforms -> (waveform, sample_rate, duration_sec).

        The reference round-trips through wav files + pydub; here segments are
        numpy float32 at self.sr and the result stays in memory (optionally
        exported to `output_path` as wav).
        """
        assert len(segments) == len(chunk_infos)
        ms = self.sr // 1000
        pieces: List[np.ndarray] = []
        for i, (seg, info) in enumerate(zip(segments, chunk_infos)):
            seg = np.asarray(seg, np.float32).reshape(-1)
            prev_info = chunk_infos[i - 1] if i > 0 else None
            next_info = chunk_infos[i + 1] if i < len(chunk_infos) - 1 else None
            seg = self.apply_smart_fades(seg, i == 0, i == len(segments) - 1,
                                         prev_info, next_info)
            pieces.append(seg)
            if i < len(segments) - 1:
                pause_ms = self.calculate_smart_pause(info, next_info)
                pieces.append(np.zeros(pause_ms * ms, np.float32))

        combined = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)

        # peak normalise, then enforce -0.5 dBFS headroom
        peak = float(np.max(np.abs(combined))) if combined.size else 0.0
        if peak > 0:
            combined = combined / peak  # pydub effects.normalize ~ peak to 0 dBFS
            combined = combined * (10.0 ** (self.headroom_dbfs / 20.0))

        if output_path:
            write_wav(output_path, combined, self.sr)
        return combined, self.sr, combined.size / self.sr

    def fallback_stitch(self, segments: Sequence[np.ndarray],
                        pause_ms: int = 250) -> np.ndarray:
        """Plain concat with fixed pauses (reference: _fallback_stitch)."""
        ms = self.sr // 1000
        silence = np.zeros(pause_ms * ms, np.float32)
        out: List[np.ndarray] = []
        for i, seg in enumerate(segments):
            out.append(np.asarray(seg, np.float32).reshape(-1))
            if i < len(segments) - 1:
                out.append(silence)
        return np.concatenate(out) if out else np.zeros(0, np.float32)

