"""T3, Chatterbox's speech-token language model (a 30-layer Llama with
conditioning), as one plain teacher-forced forward: the logits that a
served request's tokens were drawn from.

A request's sequence, for its conditional row and its unconditional row:

  [cond (speaker, 32 perceiver queries over the prompt tokens, emotion);
   text embeddings + text positions 0..lt-1; BOS; BOS;
   speech tokens 0..n-2 + speech positions 1..n-1]

at RoPE positions 0, 1, 2, ... and causal attention. The unconditional
row zeroes the text embeddings and keeps their positions. The logits at
the second BOS and at each speech token predict the next token; the
served logits are the classifier-free-guidance mix c + w (c - u) over the
speech vocabulary (ids below start_speech_token, and EOS).

`cfg` is the configuration file's "t3" dict.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import nn
from .nn import FP32, Prec


def _inv_freq(ll: dict) -> torch.Tensor:
    """llama3-scaled RoPE inverse frequencies, computed in float64."""
    d = ll["head_dim"]
    inv = 1.0 / (ll["rope_theta"] ** (np.arange(0, d, 2, dtype=np.float64) / d))
    wavelen = 2.0 * math.pi / inv
    orig, lo, hi = (ll["rope_original_max_position"], ll["rope_low_freq_factor"],
                    ll["rope_high_freq_factor"])
    smooth = (orig / wavelen - lo) / (hi - lo)
    f = ll["rope_scaling_factor"]
    scaled = np.where(wavelen > orig / lo, inv / f,
                      np.where(wavelen < orig / hi, inv, (1 - smooth) * inv / f + smooth * inv))
    return torch.from_numpy(scaled.astype(np.float32))


def _rope(x, pos, inv):
    ang = pos[:, None].float() * inv.to(x.device)[None]
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def llama(p, x, cfg_ll: dict, prec: Prec = FP32):
    """x (B, T, D) -> final-normed hidden states, causal, positions 0..T-1."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)
    inv = _inv_freq(cfg_ll)
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    nh, eps = cfg_ll["num_heads"], cfg_ll["rms_norm_eps"]
    h = x.float()
    for lp in p["layers"]:
        a = nn.rms_norm(lp["ln1"], h, eps)
        q = _rope(nn.heads(nn.linear(lp["q"], a, prec), nh), pos, inv)
        k = _rope(nn.heads(nn.linear(lp["k"], a, prec), nh), pos, inv)
        v = nn.heads(nn.linear(lp["v"], a, prec), nh)
        h = h + nn.linear(lp["o"], nn.merge(nn.attention(q, k, v, causal=causal)), prec)
        a = nn.rms_norm(lp["ln2"], h, eps)
        h = h + nn.linear(lp["down"], F.silu(nn.linear(lp["gate"], a, prec))
                          * nn.linear(lp["up"], a, prec), prec)
    return nn.rms_norm(p["norm"], h, eps)


def _perceiver_block(p, x1, x2, n_heads, prec):
    h1, h2 = nn.layer_norm(p["norm"], x1), nn.layer_norm(p["norm"], x2)
    q = nn.heads(nn.linear(p["q"], h1, prec), n_heads)
    k = nn.heads(nn.linear(p["k"], h2, prec), n_heads)
    v = nn.heads(nn.linear(p["v"], h2, prec), n_heads)
    return x1 + nn.linear(p["o"], nn.merge(nn.attention(q, k, v)), prec)


def cond_embeds(p, cfg: dict, voice: dict, prec: Prec = FP32):
    """(1, 34, D): speaker embedding, perceiver over the prompt tokens,
    emotion. voice: speaker_emb (256,), prompt_tokens (150,), emotion."""
    ce = p["cond_enc"]
    dev = p["speech_emb"]["w"].device
    spk = nn.linear(ce["spkr_enc"], torch.as_tensor(voice["speaker_emb"], dtype=torch.float32,
                                                    device=dev).reshape(1, 1, -1), prec)
    toks = torch.as_tensor(voice["prompt_tokens"], dtype=torch.long, device=dev).reshape(1, -1)
    emb = p["speech_emb"]["w"][toks].float() + p["speech_pos_emb"]["w"][: toks.shape[1]][None]
    pc = ce["perceiver"]
    query = pc["query"].float()
    pre = _perceiver_block(pc, query, emb, cfg["perceiver_num_heads"], prec)
    perc = _perceiver_block(pc, pre, pre, cfg["perceiver_num_heads"], prec)
    emo = torch.full((1, 1, 1), float(voice["emotion"]), device=dev)
    return torch.cat([spk, perc, nn.linear(ce["emotion_adv_fc"], emo, prec)], dim=1)


def served_logits(p, cfg: dict, voice: dict, text_tokens, speech_tokens, cfg_weight: float,
                  prec: Prec = FP32) -> torch.Tensor:
    """(n, V) CFG logits at each served position, -inf outside the speech
    vocabulary. text_tokens: the request's ids with start / stop text;
    speech_tokens: the n served ids (EOS included where it came)."""
    dev = p["speech_emb"]["w"].device
    tt = torch.as_tensor(np.asarray(text_tokens), dtype=torch.long, device=dev)
    st = torch.as_tensor(np.asarray(speech_tokens), dtype=torch.long, device=dev)
    n, lt = st.shape[0], tt.shape[0]
    ce = cond_embeds(p, cfg, voice, prec)[0]
    tpos = p["text_pos_emb"]["w"][:lt].float()
    te = p["text_emb"]["w"][tt].float()
    spos = p["speech_pos_emb"]["w"].float()
    bos = p["speech_emb"]["w"][cfg["start_speech_token"]].float() + spos[0]
    speech = p["speech_emb"]["w"][st[:-1]].float() + spos[1:n]
    rows = [torch.cat([ce, te + tpos, bos[None], bos[None], speech]),
            torch.cat([ce, tpos, bos[None], bos[None], speech])]
    h = llama(p["llama"], torch.stack(rows), cfg["llama"], prec)
    first = ce.shape[0] + lt + 1                 # the second BOS
    logits = nn.linear(p["speech_head"], h[:, first:first + n], prec)
    mixed = logits[0] + cfg_weight * (logits[0] - logits[1])
    ids = torch.arange(mixed.shape[-1], device=dev)
    ok = (ids < cfg["start_speech_token"]) | (ids == cfg["stop_speech_token"])
    return mixed.masked_fill(~ok, float("-inf"))


def processed(mixed: torch.Tensor, tokens, bos: int, temperature: float,
              repetition_penalty: float) -> torch.Tensor:
    """The sampler's logits before its min-p filter, as Chatterbox's
    sampler orders it: the CFG logits over the temperature, then the
    repetition penalty (a positive logit divided by it, a negative one
    multiplied) on every id already in the sequence at that position: BOS
    and the served ids before it."""
    st = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=mixed.device)
    seen = F.one_hot(st, mixed.shape[-1]).cumsum(0) - F.one_hot(st, mixed.shape[-1])
    seen[:, bos] = 1
    z = mixed / temperature
    pen = torch.where(z > 0, z / repetition_penalty, z * repetition_penalty)
    return torch.where(seen > 0, pen, z)


def min_p_margin(z: torch.Tensor, min_p: float) -> torch.Tensor:
    """How far each id lies inside the min-p filter (kept where >= 0):
    z - (the position's best + log min_p), as probabilities compare."""
    return z - (z.amax(-1, keepdim=True) + math.log(max(min_p, 1e-30)))


def sampled_gap(z: torch.Tensor, gumbel: torch.Tensor, min_p: float, tokens=None,
                lower: torch.Tensor | None = None) -> float:
    """The widest amount, over the positions, by which the reference would
    have to move its logits to draw the served token: the least eps at
    which the token passes the min-p filter within eps and no id inside the
    filter by eps or more scores above it by more than eps, the score of an
    id being its logit plus the position's Gumbel noise (the draw is the
    argmax of the scores over the filtered ids).

    z (n, V): `processed` reference logits; gumbel (n, V): the request's
    noise; tokens: the served ids; `lower` (n, V): processed logits of a
    lower-precision forward, which draws instead the id that it puts first
    under its own filter and the same noise."""
    score = z + gumbel
    margin = min_p_margin(z, min_p)
    if lower is None:
        pick = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=z.device)
    else:
        low = lower.masked_fill(min_p_margin(lower, min_p) < 0, float("-inf"))
        pick = (low + gumbel).argmax(-1)
    own = score.gather(-1, pick[:, None])
    if not bool(torch.isfinite(own).all()):
        return math.inf
    short = (-margin.gather(-1, pick[:, None])[:, 0]).clamp_min(0.0)
    # ids by margin, widest first: with the first k inside the filter by
    # eps, eps has to reach both their widest lead and the (k+1)-th margin
    m, order = margin.sort(-1, descending=True)
    lead = (score - own).gather(-1, order).cummax(-1).values
    nxt = torch.cat([m[:, 1:], torch.full_like(m[:, :1], float("-inf"))], -1)
    eps = torch.minimum(torch.maximum(lead, nxt).amin(-1), m[:, 0]).clamp_min(0.0)
    return float(torch.maximum(short, eps).max())
