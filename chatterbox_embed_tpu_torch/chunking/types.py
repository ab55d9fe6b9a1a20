"""The port's copy of `chatterbox_embed_tpu/chunking/types.py`, which imports no
jax. Chunk metadata types (reference: chunking/types.py:6-28)."""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class ContentType(Enum):
    DIALOGUE = "dialogue"
    NARRATIVE = "narrative"
    DESCRIPTIVE = "descriptive"
    TRANSITION = "transition"


@dataclass
class ChunkInfo:
    id: int
    text: str
    content_type: ContentType
    char_count: int
    word_count: int
    is_first_chunk: bool
    is_last_chunk: bool
    ending_punctuation: str
    paragraph_break_after: bool
    dialogue_ratio: float
    complexity_score: float
    has_story_break: bool = False
