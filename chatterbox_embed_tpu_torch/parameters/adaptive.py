"""The port's copy of `chatterbox_embed_tpu/parameters/adaptive.py`, which imports no
jax. Per-chunk adaptive sampling parameters (reference behaviors:
parameters/adaptive.py:14-183 — content-type profiles, complexity/position/
length/dialogue adjustments, opener preset, clamps). Constants match the
reference so converted deployments sound identical."""
from __future__ import annotations

import logging
from typing import Dict

from ..chunking.types import ChunkInfo, ContentType

logger = logging.getLogger(__name__)

CONTENT_PROFILES: Dict[ContentType, Dict[str, float]] = {
    ContentType.DIALOGUE: dict(temperature=0.8, exaggeration=0.75, cfg_weight=0.55,
                               repetition_penalty=1.2, min_p=0.05, top_p=0.9),
    ContentType.NARRATIVE: dict(temperature=0.7, exaggeration=0.55, cfg_weight=0.6,
                                repetition_penalty=1.2, min_p=0.05, top_p=0.92),
    ContentType.DESCRIPTIVE: dict(temperature=0.68, exaggeration=0.45, cfg_weight=0.58,
                                  repetition_penalty=1.15, min_p=0.05, top_p=0.94),
    ContentType.TRANSITION: dict(temperature=0.72, exaggeration=0.5, cfg_weight=0.55,
                                 repetition_penalty=1.18, min_p=0.05, top_p=0.93),
}

CLAMPS = {
    "temperature": (0.5, 1.2), "exaggeration": (0.1, 1.0), "cfg_weight": (0.2, 0.8),
    "repetition_penalty": (1.0, 1.5), "min_p": (0.01, 0.1), "top_p": (0.8, 1.0),
}


class AdaptiveParameterManager:
    def __init__(self):
        # intro boost + opener preset (reference: adaptive.py:49-82)
        self.enable_intro_boost = True
        self.intro_exaggeration_boost = 0.2
        self.intro_temperature_boost = 0.05
        self.intro_cfg_weight_factor = 0.9
        self.intro_boost_max_words = 35
        self.intro_min_words_for_boost = 12
        self.first_chunk_exaggeration_cap = 0.7
        self.first_chunk_min_cfg_weight = 0.5
        self.enable_opener_preset = True
        self.opener_temperature = 0.62
        self.opener_cfg_weight = 0.7
        self.opener_exaggeration = 0.35
        self.opener_top_p = 0.9
        self.opener_min_p = 0.05
        self.opener_repetition_penalty = 1.18

    def get_adaptive_parameters(self, info: ChunkInfo) -> Dict[str, float]:
        p = dict(CONTENT_PROFILES[info.content_type])

        # complexity (reference: adaptive.py:30-47, 88-96)
        if info.complexity_score > 6:
            p["temperature"] -= 0.1
            p["exaggeration"] -= 0.1
            p["cfg_weight"] += 0.1
        elif info.complexity_score < 3:
            p["temperature"] += 0.05
            p["exaggeration"] += 0.1
            p["cfg_weight"] -= 0.05

        if info.is_first_chunk:
            self._apply_first_chunk(p, info)
        elif info.id == 1:
            # ease out of the opener (reference: adaptive.py:136-141)
            p["temperature"] = min(p["temperature"], max(0.58, self.opener_temperature + 0.05))
            p["exaggeration"] = min(p["exaggeration"], self.first_chunk_exaggeration_cap - 0.1)
            p["cfg_weight"] = max(p["cfg_weight"],
                                  max(self.first_chunk_min_cfg_weight, self.opener_cfg_weight - 0.02))

        if info.is_last_chunk:
            p["exaggeration"] *= 0.9

        if info.char_count > 500:
            p["repetition_penalty"] *= 1.05
        elif info.char_count < 200:
            p["temperature"] *= 1.05

        if info.dialogue_ratio > 0.1:
            p["exaggeration"] = min(0.8, p["exaggeration"] * 1.15)
            p["temperature"] = max(0.6, p["temperature"] * 0.98)

        if info.content_type == ContentType.DESCRIPTIVE:
            p["temperature"] = max(0.65, p["temperature"] * 0.95)
            p["cfg_weight"] = min(0.7, p["cfg_weight"] * 1.05)
            p["repetition_penalty"] = max(1.1, p["repetition_penalty"] * 0.98)

        return self._clamp(p)

    def _apply_first_chunk(self, p: Dict[str, float], info: ChunkInfo):
        if self.enable_intro_boost:
            if info.word_count < self.intro_min_words_for_boost:
                p["exaggeration"] = min(p["exaggeration"], self.first_chunk_exaggeration_cap)
                p["cfg_weight"] = max(self.first_chunk_min_cfg_weight, p["cfg_weight"])
            elif info.word_count <= self.intro_boost_max_words:
                p["temperature"] = max(0.5, min(1.2, p["temperature"] + self.intro_temperature_boost))
                p["exaggeration"] = max(0.1, min(self.first_chunk_exaggeration_cap,
                                                 p["exaggeration"] + self.intro_exaggeration_boost))
                p["cfg_weight"] = max(self.first_chunk_min_cfg_weight,
                                      p["cfg_weight"] * self.intro_cfg_weight_factor)
            else:
                p["exaggeration"] = max(0.1, min(self.first_chunk_exaggeration_cap,
                                                 p["exaggeration"] + min(0.1, self.intro_exaggeration_boost * 0.5)))
                p["cfg_weight"] = max(self.first_chunk_min_cfg_weight, p["cfg_weight"])

        if self.enable_opener_preset and (info.word_count <= self.intro_boost_max_words
                                          or info.char_count <= 220):
            p["temperature"] = min(p["temperature"], self.opener_temperature)
            p["cfg_weight"] = max(p["cfg_weight"], self.opener_cfg_weight)
            p["exaggeration"] = min(p["exaggeration"], self.opener_exaggeration)
            p["top_p"] = min(p["top_p"], self.opener_top_p)
            p["min_p"] = max(p["min_p"], self.opener_min_p)
            p["repetition_penalty"] = max(p["repetition_penalty"], self.opener_repetition_penalty)

    @staticmethod
    def _clamp(p: Dict[str, float]) -> Dict[str, float]:
        for k, (lo, hi) in CLAMPS.items():
            if k in p:
                p[k] = max(lo, min(hi, p[k]))
        return p
