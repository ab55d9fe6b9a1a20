"""Sampling ops for the autoregressive decode, the PyTorch counterpart of
`chatterbox_embed_tpu/ops/sampling.py`: vocab masking, temperature,
repetition penalty, min-p, top-p, and the categorical draw.

The draw is argmax(logits + Gumbel noise), which is what
`jax.random.categorical` computes. The noise comes from a draw source
(`Draws`), so a test can feed JAX's own draws and get the same tokens.
"""
from __future__ import annotations

import math

import torch

NEG_INF = float("-inf")


class Draws:
    """Default source of every random draw on the main path: one
    torch.Generator seeded from `seed` on `device`.

    gumbel(step, shape)  the decode step's Gumbel noise (T3 sampling)
    phase(shape)         HiFT harmonic phases, uniform in [-pi, pi)
    noise(shape)         HiFT source noise, standard normal
    """

    def __init__(self, seed: int = 0, device="cpu"):
        self.gen = torch.Generator(device=device).manual_seed(int(seed))
        self.device = torch.device(device)

    def gumbel(self, step: int, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def phase(self, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return u * (2 * math.pi) - math.pi

    def noise(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)


def vocab_mask_logits(logits, valid_size: int, eos_id: int):
    """Allow ids < valid_size plus the EOS id."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    ok = (ids < valid_size) | (ids == eos_id)
    return logits.masked_fill(~ok, NEG_INF)


def repetition_penalty(logits, counts, penalty: float):
    """HF semantics: for every id already generated, divide positive logits by
    `penalty`, multiply negative ones."""
    penalised = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(counts > 0, penalised, logits)


def min_p_filter(logits, min_p: float):
    """Drop ids with prob < min_p * max_prob (HF MinPLogitsWarper)."""
    probs = torch.softmax(logits, dim=-1)
    thresh = min_p * probs.amax(dim=-1, keepdim=True)
    return logits.masked_fill(probs < thresh, NEG_INF)


def top_p_filter(logits, top_p: float):
    """Nucleus filtering (HF TopPLogitsWarper, min_tokens_to_keep=1)."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < top_p
    keep_sorted[..., 0] = True
    thresh = torch.where(keep_sorted, sorted_logits,
                         torch.full_like(sorted_logits, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    return logits.masked_fill(logits < thresh, NEG_INF)


def sample_token(logits, gumbel):
    """Categorical draw from (possibly -inf-masked) logits given Gumbel noise
    of the same shape. (..., V) -> (...,)."""
    return torch.argmax(logits + gumbel, dim=-1)


def process_logits(logits, counts, *, valid_size: int, eos_id: int,
                   temperature: float, repetition_penalty_val: float,
                   min_p: float, top_p: float, use_top_p: bool = True):
    """The reference order: vocab mask -> temperature -> repetition penalty
    -> min-p -> top-p. `use_top_p` keeps the vocab sort out of the loop when
    top-p is off (the reference's TopPLogitsWarper no-ops at 1.0)."""
    x = vocab_mask_logits(logits, valid_size, eos_id)
    if float(temperature) != 1.0:
        x = x / temperature
    x = repetition_penalty(x, counts, repetition_penalty_val)
    x = min_p_filter(x, min_p)
    if use_top_p:
        x = top_p_filter(x, top_p)
    return x
