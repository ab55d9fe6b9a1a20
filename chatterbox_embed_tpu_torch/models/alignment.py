"""The port's copy of `chatterbox_embed_tpu/models/alignment.py`, which imports no
jax. Alignment-informed inference heuristics (reference:
models/t3/inference/alignment_stream_analyzer.py — an attention spy on Llama
layer 9 feeding online heuristics: false-start, long-tail, repetition and
discontinuity detection, with EOS forcing/suppression via logit surgery).

The reference constructs this nowhere in its active path (t3.py:262 passes
None; the hook call in t3_hf_backend.py:109 is commented out), but it is part
of upstream's alignment-informed inference. Here it is a standalone component:
feed it one text-attention row per generated token (the decode loop can
surface layer-ALIGNMENT_LAYER's attention over the text span) and apply
`bias_logits` before sampling.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

ALIGNMENT_LAYER = 9  # reference: _add_attention_spy hooks tfmr layer 9


@dataclasses.dataclass
class AlignmentAnalysisResult:
    false_start: bool          # generation began before attending to text start
    long_tail: bool            # dwelling on the last token too long
    repetition: bool           # attention jumped backwards repeatedly
    discontinuity: bool        # attention position leapt forward
    complete: bool             # attention has covered the text
    position: int              # current attended text position


class AlignmentStreamAnalyzer:
    """Online monotonic-alignment tracker over text-attention rows."""

    def __init__(self, text_len: int, eos_idx: int = 6562):
        self.text_len = text_len
        self.eos_idx = eos_idx
        self.rows: list[np.ndarray] = []
        self.positions: list[int] = []
        self.started = False
        self.complete = False
        self.completed_at: Optional[int] = None

    def step(self, text_attention_row: np.ndarray) -> AlignmentAnalysisResult:
        """text_attention_row: (text_len,) attention mass of the newest
        generated token over the text positions."""
        row = np.asarray(text_attention_row, np.float64)
        row = row / max(row.sum(), 1e-9)
        self.rows.append(row)
        pos = int(np.argmax(row))
        self.positions.append(pos)
        t = len(self.positions)

        # false start: several tokens in, never attended to the text head
        false_start = (not self.started) and t > 8 and min(self.positions) > self.text_len // 4
        if pos <= max(1, self.text_len // 8):
            self.started = True

        # completion: attention reached the final text tokens
        if pos >= self.text_len - 2 and not self.complete:
            self.complete = True
            self.completed_at = t

        # long tail: stuck at the end for many tokens after completion
        long_tail = bool(self.complete and self.completed_at is not None
                         and (t - self.completed_at) > 15)

        # repetition: attended position moved backwards by a lot, repeatedly
        back_jumps = sum(1 for a, b in zip(self.positions[-6:-1], self.positions[-5:])
                         if b < a - 3)
        repetition = back_jumps >= 3

        # discontinuity: forward leap skipping a big chunk of text
        discontinuity = t >= 2 and (pos - self.positions[-2]) > max(6, self.text_len // 4)

        return AlignmentAnalysisResult(false_start, long_tail, repetition,
                                       discontinuity, self.complete, pos)

    def bias_logits(self, logits: np.ndarray,
                    result: AlignmentAnalysisResult) -> np.ndarray:
        """Logit surgery mirroring the reference's policy: force EOS on a long
        tail or heavy repetition; suppress EOS before the alignment completes."""
        out = np.array(logits, np.float32, copy=True)
        if result.long_tail or result.repetition:
            out[:] = -1e30
            out[self.eos_idx] = 0.0
        elif not result.complete:
            out[self.eos_idx] = -1e30
        return out
