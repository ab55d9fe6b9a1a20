"""The port's copy of `chatterbox_embed_tpu/quality/analyzer.py`, which imports no
jax. Per-chunk audio QA: silence detection, level checks, pacing bounds, 0-100
score, regen triggers (reference behaviors: quality/analyzer.py:16-239,
quality/types.py:7-15). Silence detection is vectorised numpy (25 ms windows,
10 ms hop) instead of the reference's python frame loop."""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..chunking.types import ChunkInfo

logger = logging.getLogger(__name__)

SCORE_PENALTIES = {
    "too_short": 30, "too_long": 20, "excessive_silence": 25,
    "silence_at_start": 15, "silence_at_end": 15, "too_quiet": 20,
    "too_loud": 25, "low_energy": 15, "too_slow": 20, "too_fast": 20,
    "fragmented_audio": 15,
}

SILENCE_TRIGGERS = {"excessive_silence", "silence_at_start", "silence_at_end"}
BROAD_TRIGGERS = SILENCE_TRIGGERS | {"too_short", "too_quiet", "low_energy",
                                     "fragmented_audio"}


@dataclass
class QualityScore:
    overall_score: float
    issues: List[str]
    duration: float
    silence_ratio: float
    peak_db: float
    rms_db: float
    should_regenerate: bool = False


class ChunkQualityAnalyzer:
    def __init__(self):
        self.min_duration = 0.3
        self.max_duration = 120.0
        self.silence_threshold = -30.0       # dB
        self.max_silence_ratio = 0.5
        self.min_peak_db = -25.0
        self.max_peak_db = -1.0
        self.min_rms_db = -35.0
        self.chars_per_second_range = (3.0, 35.0)
        mode = os.getenv("CHATTERBOX_QA_REGEN_MODE", "silence_only").strip().lower()
        self.regen_mode = mode if mode in {"silence_only", "broad", "off"} else "silence_only"

    def detect_silence_segments(self, audio: np.ndarray, sr: int
                                ) -> Tuple[float, List[Tuple[float, float]]]:
        win = max(1, int(sr * 0.025))
        hop = max(1, int(sr * 0.010))
        n = 1 + max(0, (len(audio) - win) // hop)
        if n <= 0:
            return 0.0, []
        idx = np.arange(n)[:, None] * hop + np.arange(win)[None, :]
        frames = audio[idx].astype(np.float64)
        rms_db = 10.0 * np.log10(np.mean(frames ** 2, axis=1) + 1e-12)
        silent = rms_db < self.silence_threshold

        # run-length encode the silent mask
        edges = np.flatnonzero(np.diff(np.concatenate([[0], silent.view(np.int8), [0]])))
        frame_time = hop / sr
        segments = [(s * frame_time, e * frame_time)
                    for s, e in zip(edges[::2], edges[1::2])]
        total = sum(e - s for s, e in segments)
        duration = len(audio) / sr
        return (total / duration if duration > 0 else 0.0), segments

    def analyze_levels(self, audio: np.ndarray) -> Tuple[float, float]:
        peak = float(np.max(np.abs(audio))) if audio.size else 0.0
        rms = float(np.sqrt(np.mean(np.square(audio)))) if audio.size else 0.0
        to_db = lambda x: 20.0 * np.log10(max(x, 1e-12)) if x > 0 else -np.inf
        return to_db(peak), to_db(rms)

    def analyze_chunk_quality(self, audio: np.ndarray, sr: int,
                              chunk_info: ChunkInfo) -> QualityScore:
        """Analyse one chunk waveform (the reference reads a wav file;
        we take the in-memory array — the TTS pipeline never leaves device
        memory until stitching)."""
        issues: List[str] = []
        audio = np.asarray(audio, np.float32).reshape(-1)
        duration = len(audio) / sr if sr else 0.0

        lo_cps, hi_cps = self.chars_per_second_range
        exp_min = max(0.2, chunk_info.char_count / hi_cps)
        exp_max = chunk_info.char_count / lo_cps
        dyn_max = min(max(15.0, exp_max * 1.5), self.max_duration)
        dyn_min = max(self.min_duration, exp_min * 0.5)
        if duration < dyn_min:
            issues.append("too_short")
        elif duration > dyn_max:
            issues.append("too_long")

        silence_ratio, segments = self.detect_silence_segments(audio, sr)
        if silence_ratio > self.max_silence_ratio:
            issues.append("excessive_silence")
        if segments:
            if segments[0][0] == 0 and segments[0][1] > 0.5:
                issues.append("silence_at_start")
            if segments[-1][1] >= duration - 0.1 and segments[-1][1] - segments[-1][0] > 0.5:
                issues.append("silence_at_end")

        peak_db, rms_db = self.analyze_levels(audio)
        if peak_db < self.min_peak_db:
            issues.append("too_quiet")
        elif peak_db > self.max_peak_db:
            issues.append("too_loud")
        if rms_db < self.min_rms_db:
            issues.append("low_energy")

        if duration > 0:
            cps = chunk_info.char_count / duration
            if cps < lo_cps:
                issues.append("too_slow")
            elif cps > hi_cps:
                issues.append("too_fast")

        if len(segments) > duration * 2:
            issues.append("fragmented_audio")

        score = max(0, 100 - sum(SCORE_PENALTIES.get(i, 10) for i in issues))
        triggers = (set() if self.regen_mode == "off"
                    else BROAD_TRIGGERS if self.regen_mode == "broad"
                    else SILENCE_TRIGGERS)
        return QualityScore(
            overall_score=score, issues=issues, duration=duration,
            silence_ratio=silence_ratio, peak_db=peak_db, rms_db=rms_db,
            should_regenerate=any(i in triggers for i in issues),
        )
