"""Conditionals: the (T3 conditioning, S3Gen reference dict) pair, in the
reference's on-disk `conds.pt` format; the PyTorch counterpart of
`chatterbox_embed_tpu/conditionals.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from .device import resolve_device
from .models.t3 import T3Cond


@dataclasses.dataclass
class Conditionals:
    """t3: T3Cond of tensors; gen: prompt_token/prompt_token_len/prompt_feat/
    prompt_feat_len/embedding (numpy arrays or tensors)."""
    t3: T3Cond
    gen: Dict[str, Any]

    def replace_emotion(self, emotion_adv: float) -> "Conditionals":
        return Conditionals(self.t3._replace(emotion_adv=float(emotion_adv)), self.gen)

    def to(self, device) -> "Conditionals":
        t3 = self.t3._replace(
            speaker_emb=self.t3.speaker_emb.to(device),
            cond_prompt_speech_tokens=(
                None if self.t3.cond_prompt_speech_tokens is None
                else self.t3.cond_prompt_speech_tokens.to(device)))
        return Conditionals(t3, self.gen)

    def save(self, path: str):
        t3_dict = {
            "speaker_emb": self.t3.speaker_emb.detach().cpu(),
            "cond_prompt_speech_tokens": (
                self.t3.cond_prompt_speech_tokens.detach().cpu()
                if self.t3.cond_prompt_speech_tokens is not None else None),
            "emotion_adv": torch.tensor(float(self.t3.emotion_adv)).reshape(1, 1, 1),
        }
        gen_dict = {k: (torch.as_tensor(np.asarray(v)) if v is not None else None)
                    for k, v in self.gen.items()}
        torch.save({"t3": t3_dict, "gen": gen_dict}, path)

    @classmethod
    def load(cls, path: str, device=None) -> "Conditionals":
        """Read a conds.pt; the T3 tensors go to `device` (None: the card)."""
        device = resolve_device(device)
        raw = torch.load(path, map_location="cpu", weights_only=True)
        t3_raw, gen_raw = raw["t3"], raw["gen"]
        prompt = t3_raw.get("cond_prompt_speech_tokens")
        emo = t3_raw.get("emotion_adv", 0.5)
        t3 = T3Cond(
            speaker_emb=torch.as_tensor(t3_raw["speaker_emb"], dtype=torch.float32),
            cond_prompt_speech_tokens=(None if prompt is None
                                       else torch.as_tensor(prompt, dtype=torch.int32)),
            emotion_adv=float(torch.as_tensor(emo).reshape(-1)[0]),
        )
        gen = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in gen_raw.items()}
        return cls(t3, gen).to(device)
