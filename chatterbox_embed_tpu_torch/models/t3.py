"""T3: token-to-token speech LM, [cond; text] -> speech tokens; the PyTorch
counterpart of `chatterbox_embed_tpu/models/t3.py` for one utterance.

- CFG (cond/uncond) is a batch of 2 rows through prefill and decode, one
  model pass per token.
- Text is LEFT-padded to its bucket with masked attention, so a bucketed
  result equals the exact-length one.
- The decode loop is a Python loop (the JAX package's lax.while_loop). It
  syncs with the host once per `EOS_CHECK_EVERY` steps to look for EOS;
  finished rows keep emitting EOS, and the output is cut after the first
  one, so the tokens are those of a per-step check.
- Every decode step's attention runs in the flash-decode kernel
  (llama.forward), so the cache capacity is rounded up to a multiple of
  256 as the JAX package does when its kernel is on (t3.py:756).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import T3Config
from ..ops import sampling
from . import layers as L
from . import llama


class T3Cond(NamedTuple):
    """Conditioning bundle of tensors."""
    speaker_emb: torch.Tensor                              # (B, 256)
    cond_prompt_speech_tokens: Optional[torch.Tensor] = None  # (B, 150)
    emotion_adv: float = 0.5


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(init: L.Init, cfg: T3Config = T3Config()):
    d = cfg.hidden_size
    qdim = cfg.perceiver_num_queries
    qvar = math.sqrt(3.0) * math.sqrt(2.0 / (qdim + qdim))
    perceiver = {
        "query": init.uniform((1, qdim, d), qvar),
        "norm": L.layer_norm_init(init, d),
        "q": L.linear_init(init, d, d),
        "k": L.linear_init(init, d, d),
        "v": L.linear_init(init, d, d),
        "o": L.linear_init(init, d, d),
    }
    return {
        "llama": llama.init(init, cfg.llama),
        "text_emb": L.embedding_init(init, cfg.text_tokens_dict_size, d, 0.02),
        "speech_emb": L.embedding_init(init, cfg.speech_tokens_dict_size, d, 0.02),
        "text_pos_emb": L.embedding_init(init, cfg.max_text_seq_len, d, 0.02),
        "speech_pos_emb": L.embedding_init(init, cfg.max_speech_seq_len, d, 0.02),
        "text_head": L.linear_init(init, d, cfg.text_tokens_dict_size, bias=False),
        "speech_head": L.linear_init(init, d, cfg.speech_tokens_dict_size, bias=False),
        "cond_enc": {
            "spkr_enc": L.linear_init(init, cfg.speaker_embed_size, d),
            "emotion_adv_fc": L.linear_init(init, 1, d, bias=False),
            "perceiver": perceiver,
        },
    }


# ---------------------------------------------------------------------------
# conditioning
# ---------------------------------------------------------------------------

def _perceiver_attn(p, x1, x2, n_heads):
    """Shared-parameter attention block: LN both inputs, MHA, residual on x1."""
    h1 = L.layer_norm(p["norm"], x1)
    h2 = L.layer_norm(p["norm"], x2)
    q = L.split_heads(L.linear(p["q"], h1), n_heads)
    kk = L.split_heads(L.linear(p["k"], h2), n_heads)
    v = L.split_heads(L.linear(p["v"], h2), n_heads)
    out = L.merge_heads(L.mha(q, kk, v))
    return x1 + L.linear(p["o"], out)


def perceiver_resample(p, h, n_heads=4):
    """32 learned queries cross-attend then self-attend."""
    query = p["query"].expand((h.shape[0],) + p["query"].shape[1:])
    pre = _perceiver_attn(p, query, h, n_heads)
    return _perceiver_attn(p, pre, pre, n_heads)


def cond_embeds(params, cond: T3Cond, cfg: T3Config = T3Config()) -> torch.Tensor:
    """Speaker, perceiver-resampled prompt and emotion embeddings: (B, 34, D)."""
    ce = params["cond_enc"]
    spk = L.linear(ce["spkr_enc"], cond.speaker_emb.reshape(-1, cfg.speaker_embed_size).float())
    parts = [spk[:, None, :]]
    if cond.cond_prompt_speech_tokens is not None:
        toks = cond.cond_prompt_speech_tokens.long()
        emb = (L.embedding(params["speech_emb"], toks)
               + params["speech_pos_emb"]["w"][: toks.shape[1]][None])
        parts.append(perceiver_resample(ce["perceiver"], emb.float(),
                                        cfg.perceiver_num_heads))
    emo = torch.full((spk.shape[0], 1, 1), float(cond.emotion_adv),
                     device=spk.device)
    parts.append(L.linear(ce["emotion_adv_fc"], emo))
    return torch.cat([p.to(spk.dtype) for p in parts], dim=1)


def cond_width(cond: T3Cond, cfg: T3Config) -> int:
    """Conditioning columns cond_embeds emits: spk(1) + perceiver(32, only
    with prompt tokens) + emotion(1)."""
    n = 1
    if cond.cond_prompt_speech_tokens is not None:
        n += cfg.perceiver_num_queries
    return n + 1


def _build_context(params, cond: T3Cond, text_tokens: torch.Tensor,
                   cfg: T3Config, cfg_on: bool, pad: int):
    """Context embeddings [junk(pad); cond; text; BOS(; BOS)] for text_tokens
    (U, T) LEFT-padded by `pad` dummy ids to the bucket width T. Rows are
    [cond; uncond] when CFG is on: the uncond rows get zero text embeddings
    but keep the text position embeddings, and the BOS is duplicated.
    Columns below `pad` are junk that every mask excludes."""
    ce = cond_embeds(params, cond, cfg)                     # (1, W, D)
    lt = text_tokens.shape[1]
    te = L.embedding(params["text_emb"], text_tokens.long()).float()
    if cfg_on:
        te = torch.cat([te, torch.zeros_like(te)], dim=0)
    rows = (torch.arange(lt, device=te.device) - pad).clamp_min(0)
    te = te + params["text_pos_emb"]["w"][rows][None].float()
    b = te.shape[0]
    ce = ce.expand((b,) + ce.shape[1:])
    bos = (params["speech_emb"]["w"][cfg.start_speech_token]
           + params["speech_pos_emb"]["w"][0]).float()
    bos = bos[None, None, :].expand(b, 1, bos.shape[-1])
    w = ce.shape[1]
    parts = [torch.zeros((b, w, te.shape[2]), dtype=te.dtype, device=te.device), te, bos]
    if cfg_on:
        parts.append(bos)
    base = torch.cat(parts, dim=1)                           # (B, W + T + nb, D)
    base[:, pad:pad + w] = ce.to(base.dtype)
    return base


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    cache: llama.KVCache
    logits: torch.Tensor        # (B, V) fp32 logits at the current position
    counts: torch.Tensor        # (U, V) int32 repetition-penalty counts


def prefill(params, context, cfg: T3Config, total: int, pad_len: int,
            cfg_on: bool = True, dtype=torch.float32) -> DecodeState:
    """Full-context forward filling a static cache of capacity `total`;
    context (B, P, D) has `pad_len` masked junk slots on the LEFT."""
    b, p_len, _ = context.shape
    dev = context.device
    cache = llama.init_cache(cfg.llama, b, total, dtype, dev)
    idx = torch.arange(p_len, device=dev)
    kidx = torch.arange(total, device=dev)
    causal = ((kidx[None, :] <= idx[:, None]) & (kidx[None, :] >= pad_len))[None]
    pos = (idx - pad_len).clamp_min(0)[None].expand(b, p_len)
    h, cache = llama.forward(params["llama"], context, pos, causal, cache=cache,
                             cache_pos=0, cfg=cfg.llama, dtype=dtype)
    logits0 = L.linear(params["speech_head"], h[:, -1], torch.float32)
    n_utt = b // 2 if cfg_on else b
    counts0 = torch.zeros((n_utt, cfg.speech_tokens_dict_size), dtype=torch.int32,
                          device=dev)
    counts0[:, cfg.start_speech_token] = 1
    return DecodeState(cache, logits0, counts0)


_TEXT_BUCKETS = (48, 96, 192, 384, 768)
DECODE_BLOCK = 256          # the JAX package's block: sets the cache capacity
EOS_CHECK_EVERY = 32        # decode steps between host checks for EOS
CACHE_ALIGN = 256           # capacity rounding of the JAX package's kernel path


def _bucket(n: int) -> int:
    for bkt in _TEXT_BUCKETS:
        if n <= bkt:
            return bkt
    return n


def start_generation(params, cond: T3Cond, text_tokens: np.ndarray, *,
                     cfg_weight: float, max_new_tokens: int,
                     cfg: T3Config = T3Config(), dtype=torch.float32,
                     device="cpu"):
    """Left-pad the text to its bucket, build the context and prefill.
    One utterance only. Returns (state, info)."""
    tt_np = np.atleast_2d(np.asarray(text_tokens, np.int32))
    u, lt = tt_np.shape
    if u != 1:
        raise ValueError(f"this port decodes one utterance; got {u} text rows")
    if lt > cfg.max_text_seq_len:
        raise ValueError(f"text too long: {lt} tokens > max {cfg.max_text_seq_len}")
    if max_new_tokens >= cfg.max_speech_seq_len:
        # step i reads speech position max_new_tokens at most; the table has
        # max_speech_seq_len rows (an index past it is a device fault on CUDA)
        raise ValueError(f"max_new_tokens={max_new_tokens} needs more than the "
                         f"{cfg.max_speech_seq_len} speech positions")
    cfg_on = float(cfg_weight) > 0.0
    pad = min(_bucket(lt), cfg.max_text_seq_len) - lt
    p_len = pad + cond_width(cond, cfg) + lt + 1 + (1 if cfg_on else 0)
    cap = p_len + max(max_new_tokens, DECODE_BLOCK)
    total = -(-cap // CACHE_ALIGN) * CACHE_ALIGN
    tb = torch.from_numpy(np.pad(tt_np, ((0, 0), (pad, 0)))).to(device)
    context = _build_context(params, cond, tb, cfg, cfg_on, pad)
    state = prefill(params, context, cfg, total, pad, cfg_on, dtype)
    info = dict(p_len=p_len, pad=pad, cfg_on=cfg_on, cache_total=total)
    return state, info


@torch.no_grad()
def generate(params, cond: T3Cond, text_tokens: np.ndarray, *,
             max_new_tokens: int = 1000, temperature: float = 0.8,
             cfg_weight: float = 0.0, repetition_penalty: float = 1.2,
             min_p: float = 0.05, top_p: float = 1.0, stop_on_eos: bool = True,
             seed: int = 0, draws=None, cfg: T3Config = T3Config(),
             dtype=torch.float32, device="cpu", info: Optional[dict] = None
             ) -> np.ndarray:
    """Speech tokens for one utterance. text_tokens: (1, T) wrapped in
    SOT/EOT. Returns the generated ids INCLUDING the terminating EOS if one
    was produced.

    draws: the Gumbel source (`sampling.Draws(seed, device)` by default).
    info: optional dict that receives p_len, pad, cache_total and
    decode_steps (the number of decode forwards run)."""
    draws = draws if draws is not None else sampling.Draws(seed, device)
    state, ginfo = start_generation(params, cond, text_tokens, cfg_weight=cfg_weight,
                                    max_new_tokens=max_new_tokens, cfg=cfg,
                                    dtype=dtype, device=device)
    p_len, pad_len, cfg_on = ginfo["p_len"], ginfo["pad"], ginfo["cfg_on"]
    cache, logits, counts = state
    n_utt = counts.shape[0]
    b = logits.shape[0]
    eos = cfg.stop_speech_token
    use_top_p = float(top_p) < 1.0
    dev = logits.device
    rows = torch.arange(n_utt, device=dev)
    done = torch.zeros((n_utt,), dtype=torch.bool, device=dev)
    tokens = torch.zeros((max_new_tokens, n_utt), dtype=torch.int64, device=dev)
    pos_emb = params["speech_pos_emb"]["w"]
    steps = 0
    for i in range(max_new_tokens):
        if cfg_on:
            lc, lu = logits[:n_utt], logits[n_utt:]
            lg = lc + cfg_weight * (lc - lu)
        else:
            lg = logits
        lg = sampling.process_logits(
            lg, counts, valid_size=cfg.start_speech_token, eos_id=eos,
            temperature=temperature, repetition_penalty_val=repetition_penalty,
            min_p=min_p, top_p=top_p, use_top_p=use_top_p)
        tok = sampling.sample_token(lg, draws.gumbel(i, tuple(lg.shape)).to(dev))
        tok = torch.where(done, torch.full_like(tok, eos), tok)  # finished rows emit EOS
        tokens[i] = tok
        counts[rows, tok] += 1
        if stop_on_eos:
            done = done | (tok == eos)
        emb = L.embedding(params["speech_emb"], tok) + pos_emb[i + 1][None]
        if cfg_on:
            emb = torch.cat([emb, emb], dim=0)
        pos_id = torch.full((b, 1), p_len - pad_len + i, dtype=torch.int64, device=dev)
        hh, cache = llama.forward(params["llama"], emb[:, None, :].to(dtype), pos_id,
                                  cache=cache, cache_pos=p_len + i, cfg=cfg.llama,
                                  dtype=dtype, flash_start=pad_len)
        logits = L.linear(params["speech_head"], hh[:, -1], torch.float32)
        steps += 1
        if stop_on_eos and (i + 1) % EOS_CHECK_EVERY == 0 and bool(done.all()):
            break
    out = tokens[:steps, 0].cpu().numpy().astype(np.int32)
    eos_at = np.nonzero(out == eos)[0]
    if stop_on_eos and eos_at.size:
        out = out[: int(eos_at[0]) + 1]
    if info is not None:
        info.update(ginfo, decode_steps=steps)
    return out
