"""Text to T3 text ids, as a deployment without a tokenizer file makes
them: one id a character, hashed into the text vocabulary, between the
start and stop text ids."""
from __future__ import annotations

import numpy as np


def text_ids(text: str, t3: dict) -> np.ndarray:
    vocab = t3["text_tokens_dict_size"]
    ids = [1 + (ord(c) * 2654435761 % (vocab - 260)) for c in text]
    return np.asarray([t3["start_text_token"], *ids, t3["stop_text_token"]], np.int64)
