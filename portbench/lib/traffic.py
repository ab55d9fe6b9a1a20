"""The one traffic generator: a cell's requests from its traffic
parameters and the run's seed.

Request k is drawn from (seed, k) alone, so a run that issues more or
fewer requests sees the same first ones. Sizes and gaps between arrivals
are stratified: each block of BLOCK requests takes the BLOCK quantiles of
the distribution, in an order drawn from the seed, so every seed brings
the same work in another order. Parameters (the "traffic" object of a
workload file):

  arrivals       "closed" (each request is due when it is issued) or
                 "poisson" with "rate" requests a second (due times are
                 the schedule's, whether or not the system keeps up)
  tokens         {"dist": "log_uniform" | "uniform", "lo", "hi"}: the
                 request's token cap (TTS) or source seconds x 25 (VC)
  chars_per_token  text characters a speech token (TTS)
  max_chars      the most characters a text may have
  voices         voices that requests take in turn
  sampling       the requests' sampling parameters (temperature,
                 cfg_weight, repetition_penalty, min_p)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np

WORDS = ("the", "a", "of", "light", "river", "stone", "quiet", "morning", "under",
         "garden", "before", "winter", "across", "small", "house", "bright", "and",
         "wind", "with", "over", "story", "little", "soft", "long", "road", "green")


@dataclass
class Request:
    k: int
    seed: int
    due: Optional[float]          # seconds after the window opens; None: when issued
    tokens: int                   # token cap, or the source's tokens (25 a second)
    voice: int
    text: str = ""


def _rng(seed: int, k: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), int(k), int(stream)])


BLOCK = 8


def quantile(seed: int, k: int, stream: int) -> float:
    """Request k's stratified quantile in (0, 1) for one random stream."""
    perm = _rng(seed, k // BLOCK, stream).permutation(BLOCK)
    return (float(perm[k % BLOCK]) + 0.5) / BLOCK


def _tokens(spec: dict, q: float) -> int:
    lo, hi = float(spec["lo"]), float(spec["hi"])
    if spec["dist"] == "log_uniform":
        return int(round(math.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))))
    if spec["dist"] == "uniform":
        return int(round(lo + q * (hi - lo)))
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def text_of(n_chars: int, rng) -> str:
    """Words from a fixed list, ending in a full stop, n_chars long."""
    words = []
    while sum(len(w) + 1 for w in words) < n_chars:
        words.append(WORDS[int(rng.integers(len(WORDS)))])
    text = " ".join(words)[: max(1, n_chars - 1)].rstrip()
    return text + "."


def request(params: dict, seed: int, k: int) -> Request:
    rng = _rng(seed, k, 0)
    n = _tokens(params["tokens"], quantile(seed, k, 1))
    text = ""
    if "chars_per_token" in params:
        n_chars = int(round(n * params["chars_per_token"]))
        text = text_of(max(8, min(params["max_chars"], n_chars)), rng)
    req_seed = int(np.random.SeedSequence([int(seed), int(k)]).generate_state(1)[0])
    return Request(k=k, seed=req_seed, due=None, tokens=n, voice=k % int(params["voices"]),
                   text=text)


def schedule(params: dict, seed: int, seconds: float) -> list:
    """Due times (seconds after the window opens) of a Poisson stream over
    `seconds`, from (seed, the arrival stream)."""
    if params["arrivals"] != "poisson":
        raise ValueError("a closed loop has no schedule")
    t, out = 0.0, []
    for j in range(1 << 30):
        t += -math.log(1.0 - quantile(seed, j, 2)) / params["rate"]
        if t >= seconds:
            return out
        out.append(t)
    return out
