"""Sampling ops for the autoregressive decode, the PyTorch counterpart of
`chatterbox_embed_tpu/ops/sampling.py`: vocab masking, temperature,
repetition penalty, min-p, top-p, and the categorical draw.

The draw is argmax(logits + Gumbel noise), which is what
`jax.random.categorical` computes. The noise comes from a draw source
(`Draws`), so a test can feed JAX's own draws and get the same tokens.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Union

import numpy as np
import torch

from ..device import resolve_device

NEG_INF = float("-inf")


class Draws:
    """Default source of every random draw on the main path: one
    torch.Generator seeded from `seed` on `device`.

    gumbel(step, shape)         the decode step's Gumbel noise (T3 sampling)
    phase(shape)                HiFT harmonic phases, uniform in [-pi, pi)
    noise(shape)                HiFT source noise, standard normal
    stream_phase(shape)         the streamed utterance's harmonic phases,
                                the same in every window
    window_noise(window, shape) the source noise of streamed window
                                `window`, standard normal
    flow_train(rows, shape)     a flow-matching training step's draws: the
                                time (rows,) uniform in [0, 1), the noise
                                `shape` standard normal, the CFG keep draw
                                (rows,) uniform in [0, 1)

    The first three and flow_train draw in call order from the one
    generator. The two
    streaming draws come from generators seeded from (seed, stream), so
    they neither consume nor depend on the others, and a window's noise
    depends on its index alone.
    """

    def __init__(self, seed: int = 0, device=None):
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(self.seed)

    def gumbel(self, step: int, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def phase(self, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return u * (2 * math.pi) - math.pi

    def noise(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def _derived(self, stream: int) -> torch.Generator:
        state = np.random.SeedSequence([self.seed, stream]).generate_state(1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(state) >> 1)

    def stream_phase(self, shape) -> torch.Tensor:
        u = torch.rand(shape, generator=self._derived(0), device=self.device)
        return u * (2 * math.pi) - math.pi

    def window_noise(self, window: int, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._derived(1 + int(window)), device=self.device)

    def flow_train(self, rows: int, shape):
        t = torch.rand((rows,), generator=self.gen, device=self.device)
        z = torch.randn(shape, generator=self.gen, device=self.device)
        keep = torch.rand((rows,), generator=self.gen, device=self.device)
        return t, z, keep


def vocab_mask_logits(logits, valid_size: int, eos_id: int):
    """Allow ids < valid_size plus the EOS id."""
    ids = torch.arange(logits.shape[-1], device=logits.device)
    ok = (ids < valid_size) | (ids == eos_id)
    return logits.masked_fill(~ok, NEG_INF)


def divide(x, value):
    """x / value, where value is a float or an fp32 tensor, rounded alike
    either way: a CUDA tensor divided by a python float is multiplied by the
    float's fp32 reciprocal (PyTorch's scalar path), so on the card a tensor
    value divides the same way, as the first chunk's CUDA graph takes its
    sampling values as tensors (streaming.py). On the CPU both divide."""
    if torch.is_tensor(value) and x.is_cuda:
        return x * torch.reciprocal(value)
    return x / value


def repetition_penalty(logits, counts, penalty: float):
    """HF semantics: for every id already generated, divide positive logits by
    `penalty`, multiply negative ones."""
    penalised = torch.where(logits > 0, divide(logits, penalty), logits * penalty)
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


class SamplingParams(NamedTuple):
    """Each field is a float for every row, or a (U, 1) fp32 tensor with
    one value per utterance row; the sampling ops broadcast either way."""
    temperature: Union[float, torch.Tensor]
    cfg_weight: Union[float, torch.Tensor]
    repetition_penalty: Union[float, torch.Tensor]
    min_p: Union[float, torch.Tensor]
    top_p: Union[float, torch.Tensor]


def sampling_param(value, n_utt: int, device=None):
    """A scalar -> float; a length-U sequence -> (U, 1) fp32 tensor on
    `device` (None: the card). Any other length raises."""
    a = np.asarray(value, np.float32)
    if a.ndim == 0:
        return float(a)
    if a.shape != (n_utt,):
        raise ValueError(f"per-row sampling param must have shape ({n_utt},), got {a.shape}")
    return torch.from_numpy(a.reshape(n_utt, 1)).to(resolve_device(device))


def process_logits(logits, counts, *, valid_size: int, eos_id: int,
                   temperature, repetition_penalty_val, min_p, top_p,
                   use_top_p: bool = True):
    """The reference order: vocab mask -> temperature -> repetition penalty
    -> min-p -> top-p. The four parameters are floats or per-row (U, 1)
    tensors. `use_top_p` keeps the vocab sort out of the loop when top-p is
    off (the reference's TopPLogitsWarper no-ops at 1.0)."""
    x = vocab_mask_logits(logits, valid_size, eos_id)
    if torch.is_tensor(temperature) or float(temperature) != 1.0:
        x = divide(x, temperature)
    x = repetition_penalty(x, counts, repetition_penalty_val)
    x = min_p_filter(x, min_p)
    if use_top_p:
        x = top_p_filter(x, top_p)
    return x
