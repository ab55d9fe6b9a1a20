"""The comparison that decides `correct`: what the timed path served,
judged by the plain reference (portbench/reference) on the same weights,
voices, texts, sources and draws, made again from the seed.

Each check returns its numbers by name. `prec` "fp32" judges the program;
"fp8" puts the reference, computed in float8, in the program's place:
the control, which a sound program has to beat (calibrate.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import nn as ref_nn
from ..reference import s3gen as ref_s3gen
from ..reference import s3tok as ref_s3tok
from ..reference import t3 as ref_t3
from ..reference.text import text_ids

from . import model

# the serving path's token buckets and prompt rounding, as it pads a dispatch
TOKEN_BUCKETS = (128, 256, 512, 1024)
PROMPT_ROUND = 64


def bucket(n: int) -> int:
    for b in TOKEN_BUCKETS:
        if n <= b:
            return b
    return n


def sq_parts(got, ref) -> tuple:
    """(squared norm of got - ref, squared norm of ref); a shape mismatch
    counts as infinitely far."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return math.inf, 1.0
    return float(np.sum((got - ref) ** 2)), float(np.sum(ref ** 2))


def pooled(parts) -> float:
    """The relative distance of several rows taken as one signal:
    sqrt(sum of squared differences / sum of squared reference values)."""
    parts = list(parts)
    return math.sqrt(sum(d for d, _ in parts) / max(sum(r for _, r in parts), 1e-24))


def clean(tokens, cfg: dict) -> np.ndarray:
    """The speech ids a served row vocodes: up to the first EOS, below the
    speech vocabulary."""
    t = np.asarray(tokens).reshape(-1)
    eos = np.nonzero(t == cfg["t3"]["stop_speech_token"])[0]
    t = t[: eos[0]] if eos.size else t
    return t[t < cfg["t3"]["start_speech_token"]]


def reference_weights(cfg: dict, parts, seed: int, device):
    ref_nn.exact_fp32()
    return model.make_weights(cfg, parts, seed, device, served=False)


def s3gen_numbers(p, cfg: dict, src, ids, gen: dict, width: int, p_width: int, mel, wav,
                  cache_every: int, prec: str) -> tuple:
    """The squared parts of mel_rel and of hift_vs_bf16 of one served row:
    (the flow's mel against the reference's from the same tokens, over the
    generated frames; the wav against the reference's HiFT on the same
    mel; the reference's HiFT with bf16 operands against it, the yardstick
    of bf16 rounding on these weights). With a control precision, the
    reference in that precision takes the program's place, its HiFT on its
    own mel."""
    toks = clean(ids, cfg)
    r = 2 * len(toks)
    ref_mel = ref_s3gen.flow(p["s3gen"], toks, gen, width, p_width, cfg["s3gen"],
                             cache_every=cache_every)
    if prec != "fp32":
        low = ref_nn.Prec(prec)
        mel = ref_s3gen.flow(p["s3gen"], toks, gen, width, p_width, cfg["s3gen"], low,
                             cache_every).cpu().numpy()
    phase, noise = src.phase[0, :, 0], src.noise[0]

    def hift(prec_):
        return ref_s3gen.vocode(p["s3gen"], mel, len(toks), phase, noise, cfg["s3gen"], prec_)

    ref_wav = hift(ref_nn.FP32)
    if prec != "fp32":
        wav = hift(ref_nn.Prec(prec))
    return (sq_parts(np.asarray(mel)[:r], ref_mel[:r].cpu().numpy()), sq_parts(wav, ref_wav),
            sq_parts(hift(ref_nn.Prec("bf16")), ref_wav))


def hift_vs_bf16(rows) -> float:
    """The rows' wav distance from the reference's HiFT over the distance
    that bf16 operands alone give, both pooled over the rows."""
    return math.sqrt(sum(x[1][0] for x in rows) / max(sum(x[2][0] for x in rows), 1e-30))


def tts_checks(cfg: dict, seed: int, voices: list, t3_rows: list, wav_rows: list, device,
               prec: str = "fp32", p=None) -> dict:
    """t3_rows: [(text, voice index, served ids, sampling parameters, the
    request's draw seed)]; wav_rows: [(served ids, voice index, (dispatch
    width, rows in the flush), wav, the mel HiFT was given)]. Returns
    {"t3_gap": the widest sampled gap (`ref_t3.sampled_gap`) over the
    rows, "mel_rel": the rows' mel distance from the reference, pooled
    over the rows (`pooled`), "hift_vs_bf16"}. p: the reference's weights,
    if made already."""
    p = p or reference_weights(cfg, ("t3", "flow", "hift"), seed, device)
    t3 = cfg["t3"]
    out = {}
    with torch.no_grad():
        gaps = []
        for text, vi, ids, sp, draw_seed in t3_rows:
            v = voices[vi]
            tt = text_ids(text, t3)
            g = model.gumbel_steps(draw_seed, len(ids), t3["speech_tokens_dict_size"], device)

            def z(prec_):
                mixed = ref_t3.served_logits(p["t3"], t3, v, tt, ids, sp["cfg_weight"], prec_)
                return ref_t3.processed(mixed, ids, t3["start_speech_token"], sp["temperature"],
                                        sp["repetition_penalty"])

            lower = None if prec == "fp32" else z(ref_nn.Prec(prec))
            gaps.append(ref_t3.sampled_gap(z(ref_nn.FP32), g, sp["min_p"], ids, lower))
        if gaps:
            out["t3_gap"] = max(gaps)
        src = model.source(cfg, seed, device)
        rows = []
        for ids, vi, (width, u), wav, mel in wav_rows:
            gen = voices[vi]["gen"]
            n_p = int(np.asarray(gen["prompt_token"]).shape[-1])
            p_width = max(PROMPT_ROUND, -(-n_p // PROMPT_ROUND) * PROMPT_ROUND)
            rows.append(s3gen_numbers(p, cfg, src, ids, gen, width, p_width, mel, wav,
                                      2 if u >= 8 else 0, prec))
        if rows:
            out["mel_rel"] = pooled(x[0] for x in rows)
            out["hift_vs_bf16"] = hift_vs_bf16(rows)
    return out


def vc_checks(cfg: dict, seed: int, voices: list, rows: list, device, prec: str = "fp32",
              margin: float = 1e-3) -> dict:
    """rows: [(16 kHz source, voice index, served ids, served wav, the mel
    HiFT was given)]. Returns {"token_mismatch": the largest share of
    tokens (clear of a rounding boundary by `margin`) that differ from the
    reference tokenizer's, "mel_rel", "hift_vs_bf16": as tts_checks}."""
    p = reference_weights(cfg, ("flow", "hift", "tokenizer"), seed, device)
    src = model.source(cfg, seed, device)
    mism, nums = [], []
    tok_cfg = cfg["s3gen"]["tokenizer"]
    with torch.no_grad():
        for wav16, vi, ids, wav, mel in rows:
            x = torch.from_numpy(ref_s3tok.pad(np.asarray(wav16, np.float32))).to(device)
            pre = ref_s3tok.pre_round(p["s3gen"]["tokenizer"], x, tok_cfg)
            served = ids if prec == "fp32" else ref_s3tok.tokens(
                ref_s3tok.pre_round(p["s3gen"]["tokenizer"], x, tok_cfg, ref_nn.Prec(prec)))
            mism.append(ref_s3tok.mismatch_share(served, pre, margin))
            gen = voices[vi]["gen"]
            n_p = int(np.asarray(gen["prompt_token"]).shape[-1])
            nums.append(s3gen_numbers(p, cfg, src, ids, gen, bucket(len(ids)), n_p, mel, wav, 0,
                                      prec))
    return {"token_mismatch": max(mism), "mel_rel": pooled(x[0] for x in nums),
            "hift_vs_bf16": hift_vs_bf16(nums)}


def verdict(numbers: dict, limits: dict):
    """(correct, [(name, number, limit)]): every limit named must have its
    number, at or under it."""
    rows = [(k, numbers.get(k, math.inf), float(v)) for k, v in limits.items()]
    return all(x <= lim for _, x, lim in rows), rows
