"""Punctuation normalisation for LLM-produced text, the port's copy of
`chatterbox_embed_tpu/text/normalization.py`."""
from __future__ import annotations

_REPLACEMENTS = [
    ("...", ". "),
    ("…", ". "),
    (":", ","),
    (" - ", ", "),
    (";", ", "),
    ("—", "-"),
    ("–", "-"),
    (" ,", ","),
]

_SENTENCE_ENDERS = (".", "!", "?", "-", ",")


def punc_norm(text: str) -> str:
    if len(text) == 0:
        return "You need to add some text for me to talk."
    if text[0].islower():
        text = text[0].upper() + text[1:]
    text = " ".join(text.split())
    for old, new in _REPLACEMENTS:
        text = text.replace(old, new)
    text = text.rstrip(" ")
    if not text.endswith(_SENTENCE_ENDERS):
        text += "."
    return text
