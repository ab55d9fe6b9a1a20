"""The comparison that decides `correct` for T3 on the Kimi-Linear
backbone: what the timed path served, judged by the plain reference
(`reference/kimi_linear.py`, T3's part from `reference/t3.py`) on the same
weights, voices, texts and draws, made again from the seed.

As lib/check_dsv2.py: the reference runs teacher-forced, layer by layer,
with the program's expert ids forced (the routing record the engine kept
for each served request) and the router's own renormalised fp32 sigmoid
scores of those ids as their weights, so that a near-tie that rounding
flips costs nothing while a wrong expert shows:

- `t3_gap`: as tts-backlog's (`reference/t3.sampled_gap`), on these logits;
- `route_gap`: over every forced choice of every position, row and MoE
  layer, how far the forced expert's choice score (sigmoid score plus the
  correction bias) lies below the reference's own k-th best (0 where they
  agree);
- `kda_state_rel`: the state that the engine held for each request in its
  first KDA layer when it finished (both rows, after its context and the
  n - 1 tokens it fed back; `t3_engine.KdaRoute`) against the reference's
  after the same positions: the largest ||program - reference|| /
  ||reference|| of one head's state, over the heads, rows and requests.
  The logits hardly move when the state loses precision, the state itself
  does; the first layer's inputs are the embeddings, so what it holds
  differs from the reference's by the bf16 projections alone, where a
  deeper layer's carries every layer's rounding before it. The rounding of
  those projections is fresh at every token and stays at the level of one
  rounding; a state kept in a lower precision adds a rounding at every
  token, which builds up over the head's memory, so the worst head (the
  slowest decay) shows it best;
- `mel_rel`, `hift_vs_bf16`: S3Gen's, as lib/check.py computes them.

With a control precision ("fp8") the reference in that precision takes
the program's place: it routes itself and draws its own tokens (`lower`),
and the fp32 reference is forced with its routing.
"""
from __future__ import annotations

import torch

from ..reference import kimi_linear as ref_kimi
from ..reference import nn as ref_nn
from ..reference import t3 as ref_t3
from ..reference.text import text_ids
from . import check, model, model_dsv2, model_kimi


def t3_numbers(cfg: dict, seed: int, voices: list, t3_rows: list, device,
               prec: str = "fp32") -> dict:
    """t3_rows: [(text, voice index, served ids, sampling parameters, the
    request's draw seed, its engine record `t3_engine.KdaRoute`: its routes
    (moe layers, positions, 2, k) and its first KDA layer's state)]."""
    ref_nn.exact_fp32()
    t3c = cfg["t3"]
    p = model_kimi.make_t3(cfg, seed, device, served=False, layers=False)

    def layer_of(i):
        return model_kimi.reference_layer(cfg, seed, device, i)

    reqs = [(voices[vi], text_ids(text, t3c), ids, sp["cfg_weight"], kept.ids)
            for text, vi, ids, sp, _, kept in t3_rows]
    steps = [len(ids) - 1 for _, _, ids, *_ in t3_rows]            # the tokens fed back
    held = [kept.kda_state.to(device) for *_, kept in t3_rows]      # (2, H, dk, dv)
    lower = [None] * len(reqs)
    if prec != "fp32":
        lower, _, own, own_states = ref_kimi.served(p, layer_of, cfg, reqs, ref_nn.Prec(prec),
                                                    forced=False, steps=steps)
        reqs = [r[:4] + (o,) for r, o in zip(reqs, own)]
        held = [st[0] for st in own_states]
    mixed, route_gaps, _, states = ref_kimi.served(p, layer_of, cfg, reqs, steps=steps)
    state_rel = max(_worst_head(got, want[0]) for got, want in zip(held, states))
    gaps = []
    for (text, vi, ids, sp, draw_seed, _), z, low in zip(t3_rows, mixed, lower):
        g = model.gumbel_steps(draw_seed, len(ids), t3c["speech_tokens_dict_size"], device)

        def proc(x):
            return ref_t3.processed(x, ids, t3c["start_speech_token"], sp["temperature"],
                                    sp["repetition_penalty"])

        gaps.append(ref_t3.sampled_gap(proc(z), g, sp["min_p"], ids,
                                       None if low is None else proc(low)))
    return {"t3_gap": max(gaps), "route_gap": max(route_gaps), "kda_state_rel": state_rel}


def _worst_head(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest ||got - want|| / ||want|| of one head's state: (2, H, dk,
    dv) each."""
    err = (got.float() - want).flatten(-2).norm(dim=-1)
    return float((err / want.flatten(-2).norm(dim=-1)).max())


def tts_checks(cfg: dict, seed: int, voices: list, t3_rows: list, wav_rows: list, device,
               prec: str = "fp32") -> dict:
    """t3_rows as `t3_numbers`; wav_rows as lib/check.tts_checks. Returns
    {"t3_gap", "route_gap", "kda_state_rel", "mel_rel", "hift_vs_bf16"}."""
    out = {}
    with torch.no_grad():
        if t3_rows:
            out.update(t3_numbers(cfg, seed, voices, t3_rows, device, prec))
        p = check.reference_weights(model_dsv2._s3gen_view(cfg), ("flow", "hift"), seed, device)
    out.update(check.tts_checks(cfg, seed, voices, [], wav_rows, device, prec, p=p))
    return out
