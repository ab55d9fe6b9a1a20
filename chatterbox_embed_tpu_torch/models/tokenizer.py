"""English BPE text tokenizer, the counterpart of
`chatterbox_embed_tpu/models/tokenizer.py` (it wraps the HF `tokenizers`
runtime, imported when a tokenizer is built), plus the hash fallback used
with random weights when no tokenizer.json exists."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

SOT = "[START]"
EOT = "[STOP]"
UNK = "[UNK]"
SPACE = "[SPACE]"


class EnTokenizer:
    def __init__(self, vocab_file_path: str):
        from tokenizers import Tokenizer
        self.tokenizer = Tokenizer.from_file(vocab_file_path)
        voc = self.tokenizer.get_vocab()
        if SOT not in voc or EOT not in voc:
            raise ValueError("tokenizer.json missing [START]/[STOP]")

    def text_to_tokens(self, text: str) -> np.ndarray:
        return np.asarray(self.encode(text), np.int32)[None, :]

    def encode(self, txt: str) -> List[int]:
        txt = txt.replace(" ", SPACE)
        return self.tokenizer.encode(txt).ids

    def decode(self, seq: Sequence[int]) -> str:
        txt = self.tokenizer.decode(list(np.asarray(seq).reshape(-1)),
                                    skip_special_tokens=False)
        return (txt.replace(" ", "").replace(SPACE, " ")
                .replace(EOT, "").replace(UNK, ""))


class FallbackTokenizer:
    """Hash tokenizer for random-weight runs without a tokenizer.json: one
    token per character (the JAX package's tts._FallbackTokenizer)."""

    def __init__(self, t3_cfg):
        self.vocab = t3_cfg.text_tokens_dict_size

    def text_to_tokens(self, text: str) -> np.ndarray:
        ids = [1 + (ord(c) * 2654435761 % (self.vocab - 260)) for c in text]
        return np.asarray(ids, np.int32)[None, :]

    def encode(self, text: str):
        return list(self.text_to_tokens(text)[0])

    def decode(self, seq):
        return "".join("?" for _ in np.asarray(seq).reshape(-1))
