"""The port's copy of `chatterbox_embed_tpu/chunking/smart_chunker.py`, which imports no
jax. Content-aware text chunking (reference behaviors:
chunking/smart_chunker.py:31-255 — weighted-punctuation break search,
content-type classification, complexity scoring, paragraph handling)."""
from __future__ import annotations

import logging
import re
from typing import List, Tuple

from .types import ChunkInfo, ContentType

logger = logging.getLogger(__name__)

_DIALOGUE_CHARS = set('"\'""«»')
_NARRATIVE_WORDS = ("suddenly", "meanwhile", "then", "next", "after", "before",
                    "during", "while")
_TRANSITION_WORDS = ("however", "therefore", "nevertheless", "furthermore",
                     "moreover", "consequently")
_PUNCT_WEIGHT = {".": 1.0, "!": 1.0, "?": 1.0, ";": 0.7, ":": 0.5, ",": 0.3,
                 "—": 0.6, "–": 0.6}


def classify_content(text: str) -> ContentType:
    lower = text.lower()
    dialogue_count = sum(1 for c in text if c in _DIALOGUE_CHARS)
    if (dialogue_count / max(len(text), 1)) > 0.02 or text.count('"') >= 2:
        return ContentType.DIALOGUE
    if sum(1 for w in _NARRATIVE_WORDS if w in lower) >= 2:
        return ContentType.NARRATIVE
    if any(w in lower for w in _TRANSITION_WORDS):
        return ContentType.TRANSITION
    return ContentType.DESCRIPTIVE


def complexity_score(text: str) -> float:
    """0-10 score from word/sentence length and punctuation density."""
    words = text.split()
    if not words:
        return 0.0
    avg_word = sum(len(w.strip('.,!?;:"')) for w in words) / len(words)
    sentences = max(sum(1 for c in text if c in ".!?"), 1)
    avg_sentence = len(words) / sentences
    punct_density = sum(1 for c in text if c in '.,!?;:"-') / len(text)
    complex_ratio = sum(1 for c in text if c in ";:—–") / len(text)
    score = ((avg_word - 4) * 0.3 + (avg_sentence - 10) * 0.2
             + punct_density * 50 * 0.3 + complex_ratio * 100 * 0.2)
    return max(0.0, min(10.0, score))


class SmartChunker:
    """Splits sanitised text into generation-sized chunks at natural breaks."""

    def find_break(self, text: str, start: int, max_chars: int) -> Tuple[int, float]:
        """Best break position in [start + max/2, start + max), scored by
        punctuation strength and closeness to the 80% point."""
        if start + max_chars >= len(text):
            return len(text), 1.0
        lo = start + max_chars // 2
        hi = min(start + max_chars, len(text))
        ideal = start + int(max_chars * 0.8)

        best_pos, best_score = hi, 0.0
        for i in range(lo, hi):
            w = _PUNCT_WEIGHT.get(text[i])
            if w is None:
                continue
            position_pref = 1.0 - abs(i - ideal) / max_chars
            space_bonus = 0.1 if i + 1 < len(text) and text[i + 1] == " " else 0.0
            score = w * 0.7 + position_pref * 0.2 + space_bonus
            if score > best_score:
                best_score, best_pos = score, i + 1
        if best_score <= 0.0:
            # no punctuation: snap to whitespace (backwards first, short forward window)
            back = text.rfind(" ", lo, hi)
            if back > lo:
                best_pos = back + 1
            else:
                fwd = text.find(" ", hi, min(len(text), hi + 40))
                if fwd != -1:
                    best_pos = fwd + 1
        return best_pos, best_score

    def smart_chunk(self, text: str, target_chars: int = 400,
                    max_chars: int = 600) -> List[ChunkInfo]:
        text = (text or "").strip()
        if not text:
            return []
        # paragraphs: blank-line separated, inner newlines joined
        paragraphs = [re.sub(r"\s*\n\s*", " ", p).strip()
                      for p in re.split(r"\n\s*\n", text) if p.strip()]
        chunks: List[ChunkInfo] = []
        for pi, para in enumerate(paragraphs):
            start_idx = len(chunks)
            pos = 0
            while pos < len(para):
                if len(para) - pos <= max_chars:
                    piece, pos = para[pos:], len(para)
                else:
                    end, _ = self.find_break(para, pos, target_chars)
                    piece, pos = para[pos:end], end
                piece = piece.strip()
                if piece:
                    chunks.append(self._make(len(chunks), piece))
            if chunks and pi < len(paragraphs) - 1:
                chunks[-1].paragraph_break_after = True
            del start_idx
        if chunks:
            chunks[0].is_first_chunk = True
            chunks[-1].is_last_chunk = True
        logger.info("smart chunking: %d chars -> %d chunks", len(text), len(chunks))
        return chunks

    def _make(self, cid: int, text: str) -> ChunkInfo:
        stripped = text.rstrip()
        dialogue = sum(1 for c in text if c in _DIALOGUE_CHARS) / max(len(text), 1)
        return ChunkInfo(
            id=cid, text=text, content_type=classify_content(text),
            char_count=len(text), word_count=len(text.split()),
            is_first_chunk=False, is_last_chunk=False,
            ending_punctuation=stripped[-1] if stripped else ".",
            paragraph_break_after=False, dialogue_ratio=dialogue,
            complexity_score=complexity_score(text),
        )
