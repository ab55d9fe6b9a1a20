"""The comparison that decides `correct` for T3 on the DeepSeek-V2
backbone: what the timed path served, judged by the plain reference
(`reference/dsv2.py`, T3's part from `reference/t3.py`) on the same
weights, voices, texts and draws, made again from the seed.

The reference runs teacher-forced with the program's expert ids forced
(the routing record the engine kept for each served request) and the
router's own fp32 scores of those ids as their weights, so that a near-tie
that rounding flips costs nothing while a wrong expert shows:

- `t3_gap`: as tts-backlog's (`reference/t3.sampled_gap`), on these logits;
- `route_gap`: over every forced choice of every position, row and MoE
  layer, how far the forced expert's reference score lies below the
  reference's own k-th best score (0 where they agree);
- `mel_rel`, `hift_vs_bf16`: S3Gen's, as lib/check.py computes them.

With a control precision ("fp8") the reference in that precision takes
the program's place: it routes itself and draws its own tokens (`lower`),
and the fp32 reference is forced with its routing.
"""
from __future__ import annotations

from ..reference import dsv2 as ref_dsv2
from ..reference import nn as ref_nn
from ..reference import t3 as ref_t3
from ..reference.text import text_ids
from . import check, model, model_dsv2


def t3_numbers(cfg: dict, seed: int, voices: list, t3_rows: list, device,
               prec: str = "fp32") -> dict:
    """t3_rows: [(text, voice index, served ids, sampling parameters, the
    request's draw seed, its routes (moe layers, positions, 2, k))]."""
    ref_nn.exact_fp32()
    t3c = cfg["t3"]
    p = model_dsv2.make_t3(cfg, seed, device, served=False, layers=False)

    def layer_of(i):
        return model_dsv2.reference_layer(cfg, seed, device, i)

    reqs = [(voices[vi], text_ids(text, t3c), ids, sp["cfg_weight"], routes)
            for text, vi, ids, sp, _, routes in t3_rows]
    lower = [None] * len(reqs)
    if prec != "fp32":
        lower, _, own = ref_dsv2.served(p, layer_of, cfg, reqs, ref_nn.Prec(prec), forced=False)
        reqs = [r[:4] + (o,) for r, o in zip(reqs, own)]
    mixed, route_gaps, _ = ref_dsv2.served(p, layer_of, cfg, reqs)
    gaps = []
    for (text, vi, ids, sp, draw_seed, _), z, low in zip(t3_rows, mixed, lower):
        g = model.gumbel_steps(draw_seed, len(ids), t3c["speech_tokens_dict_size"], device)

        def proc(x):
            return ref_t3.processed(x, ids, t3c["start_speech_token"], sp["temperature"],
                                    sp["repetition_penalty"])

        gaps.append(ref_t3.sampled_gap(proc(z), g, sp["min_p"], ids,
                                       None if low is None else proc(low)))
    return {"t3_gap": max(gaps), "route_gap": max(route_gaps)}


def tts_checks(cfg: dict, seed: int, voices: list, t3_rows: list, wav_rows: list, device,
               prec: str = "fp32") -> dict:
    """t3_rows as `t3_numbers`; wav_rows as lib/check.tts_checks. Returns
    {"t3_gap", "route_gap", "mel_rel", "hift_vs_bf16"}."""
    import torch
    out = {}
    with torch.no_grad():
        if t3_rows:
            out.update(t3_numbers(cfg, seed, voices, t3_rows, device, prec))
        p = check.reference_weights(model_dsv2._s3gen_view(cfg), ("flow", "hift"), seed, device)
    out.update(check.tts_checks(cfg, seed, voices, [], wav_rows, device, prec, p=p))
    return out
