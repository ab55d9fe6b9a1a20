"""T3: token-to-token speech LM, [cond; text] -> speech tokens; the PyTorch
counterpart of `chatterbox_embed_tpu/models/t3.py`: one utterance
(`generate`) or many decoded in lock-step (`generate_batch`).

- CFG (cond/uncond) doubles the rows through prefill and decode: U
  utterances decode as 2U rows, one model pass per token.
- Text is LEFT-padded to its bucket with masked attention, so a bucketed
  result equals the exact-length one. In a batch, each row's text is also
  RIGHT-padded to the longest; its pad keys are masked in prefill and cut
  from every decode step as a per-row hole [lo, hi) of the flash-decode
  kernel.
- The decode is resumable: `decode_block` runs up to `block` steps from a
  `DecodeState` (the JAX package's lax.while_loop) as a Python loop, and
  `generate_stream` yields each block's tokens. The host looks for EOS
  once per `EOS_CHECK_EVERY` steps; finished rows keep emitting EOS, and
  the output is cut after the first one, so the tokens are those of a
  per-step check. Step i draws its Gumbel noise by its global index.
- `decode_fixed_block` is the same block as fixed steps that never wait on
  the host (n_new, the done flags and the step count stay on the device,
  the text's left pad may be a device value): the stream's first chunk,
  which the card captures as one CUDA graph per text bucket (streaming.py).
- Under CHATTERBOX_FUSED_STEP=1 a decode step of unragged rows runs the
  whole backbone in one fused kernel (K4, `kernels/fused_decode.py`), when
  the backbone's weights are not int8 (K4 streams a bf16 wall).
- Every decode step's attention runs in a kernel that walks only the live
  cache slots (the flash-decode kernel in llama.forward at every row count,
  or the fused step), so the cache capacity is rounded up to a multiple of
  256 as the JAX package does when its kernels are on (t3.py:756). For the
  same reason the JAX package's phased reads (early decode phases reading
  a shorter prefix of the cache) buy nothing here: the port decodes in one
  phase.
- CHATTERBOX_INT8_KV=1 (read at call time) keeps the cache in int8 with
  per-(slot, row, head) scales (models/llama.py) at every row count, except
  under the fused step, which walks its own cache in the compute dtype
  (the JAX package's rule, whose XLA-only int8 cache also yields to its
  Pallas decode kernel; the port's K1 reads int8). The utterance cap then
  doubles and the fence counts the scale planes too.
- Sampling parameters are one value for every row or one per utterance
  (ops/sampling.py:SamplingParams); each sub-batch of `generate_batch`
  draws from its own source.
- The alignment guard (`alignment=True`; the JAX package's on-device copy
  of models/alignment.py): layer min(ALIGNMENT_LAYER, L-1) runs plain
  attention and returns its head-mean probabilities; their argmax over a
  row's text span drives a per-row ring of attended positions, which
  suppresses EOS until attention reaches the text's tail and forces it on a
  long dwell there or on repeated backward jumps. Every other layer keeps
  K1 (K1s); the fused step is off under the guard.
- On a mesh (`mesh=`, parallel/): every rank builds the whole context,
  prefills and decodes its rows of the [cond; uncond] rows (split over dp
  as the JAX package shards them) through its Megatron shard of the
  backbone (tp), and the rows' logits are gathered over dp once a step, so
  that every rank samples every utterance from the one seeded draw source
  and holds the same tokens. A CFG pair's two rows may live on two ranks,
  which is why the logits, not the tokens, are gathered. K4 is off under a
  mesh, as in the JAX package, and so is the utterance fence: a mesh call
  decodes its batch in one piece. `generate`, `generate_batch` and
  `start_generation` called on the leader run on every rank
  (`parallel.mesh.on_mesh`); `decode_block` runs inside such a call.
- The backbone is chosen by its config (models/backbone.py): `cfg.llama` a
  LlamaConfig (Llama_520M, models/llama.py) or a DeepseekV2Config
  (models/deepseek_v2.py: latent attention, routed experts), whose params
  sit under the same key and whose module gives the same face. The latter
  runs init, prefill, the lock-step decode and the teacher-forced forward;
  what it does not run raises where it is asked for (`backbone.check`).
- Training: `forward` runs [cond; text; speech] teacher-forced through
  plain attention under a causal, key-valid mask, and `loss` is the masked
  cross-entropy with the JAX package's next-token shift; neither runs under
  no_grad (the generation functions do). On a dp x tp mesh `loss` runs each
  rank's rows through its shard over the whole batch's denominator
  (training/train_step.py); parallel/pipeline.py runs the same context,
  layers and heads in stages.
"""
from __future__ import annotations

import functools
import math
import os
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import T3Config
from ..device import resolve_device
from ..kernels import fused_decode
from ..ops import sampling
from ..parallel.mesh import on_mesh
from ..parallel.serve import shard_generation_inputs
from . import backbone
from . import layers as L
from . import llama
from .alignment import ALIGNMENT_LAYER


class T3Cond(NamedTuple):
    """Conditioning bundle of tensors: one voice (1 row) or one per
    utterance (U rows); emotion_adv is a float or a (U,) tensor."""
    speaker_emb: torch.Tensor                              # (1|U, 256)
    cond_prompt_speech_tokens: Optional[torch.Tensor] = None  # (1|U, 150)
    emotion_adv: Union[float, torch.Tensor] = 0.5


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
        "llama": backbone.of(cfg.llama).init(init, cfg.llama),
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
    """Speaker, perceiver-resampled prompt and emotion embeddings:
    (rows, 34, D). The emotion may carry one value per utterance while the
    voice is shared: every part broadcasts to the wider row count."""
    ce = params["cond_enc"]
    spk = L.linear(ce["spkr_enc"], cond.speaker_emb.reshape(-1, cfg.speaker_embed_size).float())
    parts = [spk[:, None, :]]
    if cond.cond_prompt_speech_tokens is not None:
        toks = cond.cond_prompt_speech_tokens.long()
        emb = (L.embedding(params["speech_emb"], toks)
               + params["speech_pos_emb"]["w"][: toks.shape[1]][None])
        parts.append(perceiver_resample(ce["perceiver"], emb.float(),
                                        cfg.perceiver_num_heads))
    emo = torch.as_tensor(cond.emotion_adv, dtype=torch.float32,
                          device=spk.device).reshape(-1, 1, 1)
    rows = max(spk.shape[0], emo.shape[0])
    parts.append(L.linear(ce["emotion_adv_fc"], emo.expand(rows, 1, 1)))
    return torch.cat([p.expand((rows,) + p.shape[1:]).to(spk.dtype) for p in parts], dim=1)


def cond_width(cond: T3Cond, cfg: T3Config) -> int:
    """Conditioning columns cond_embeds emits: spk(1) + perceiver(32, only
    with prompt tokens) + emotion(1)."""
    n = 1
    if cond.cond_prompt_speech_tokens is not None:
        n += cfg.perceiver_num_queries
    return n + 1


def _build_context(params, cond: T3Cond, text_tokens: torch.Tensor,
                   cfg: T3Config, cfg_on: bool, pad):
    """Context embeddings [junk(pad); cond; text; BOS(; BOS)] for text_tokens
    (U, T) LEFT-padded by `pad` dummy ids to the bucket width T. Rows are
    [cond rows; uncond rows] when CFG is on: the uncond rows get zero text
    embeddings but keep the text position embeddings, and the BOS is
    duplicated. With per-utterance conditioning (U cond rows) the uncond
    rows keep the full conditioning too. Columns below `pad` are junk that
    every mask excludes. `pad` is an int or a one-element tensor on the
    device (the JAX package traces it: one first-chunk graph serves every
    text length of a bucket, streaming.py)."""
    ce = cond_embeds(params, cond, cfg)                     # (1 or U, W, D)
    u, lt = text_tokens.shape
    te = L.embedding(params["text_emb"], text_tokens.long()).float()
    if cfg_on:
        te = torch.cat([te, torch.zeros_like(te)], dim=0)
    rows = (torch.arange(lt, device=te.device) - pad).clamp_min(0)
    te = te + params["text_pos_emb"]["w"][rows][None].float()
    b = te.shape[0]
    if ce.shape[0] == u and cfg_on:
        ce = torch.cat([ce, ce], dim=0)
    else:
        ce = ce.expand((b,) + ce.shape[1:])
    bos = (params["speech_emb"]["w"][cfg.start_speech_token]
           + params["speech_pos_emb"]["w"][0]).float()
    bos = bos[None, None, :].expand(b, 1, bos.shape[-1])
    w = ce.shape[1]
    parts = [torch.zeros((b, w, te.shape[2]), dtype=te.dtype, device=te.device), te, bos]
    if cfg_on:
        parts.append(bos)
    base = torch.cat(parts, dim=1)                           # (B, W + T + nb, D)
    if not torch.is_tensor(pad):
        base[:, pad:pad + w] = ce.to(base.dtype)
        return base
    # the conditioning lands at columns [pad, pad + w), gathered on the device
    col = torch.arange(base.shape[1], device=base.device)
    rel = col - pad.reshape(()).long()
    at = ((rel >= 0) & (rel < w))[None, :, None]
    return torch.where(at, ce.to(base.dtype)[:, rel.clamp(0, w - 1)], base)


# ---------------------------------------------------------------------------
# training forward / loss (the JAX package's t3.forward and t3.loss)
# ---------------------------------------------------------------------------

def _train_context(params, cond: T3Cond, text_tokens, text_lens, speech_tokens, speech_lens,
                   cfg: T3Config):
    """The teacher-forced input of B rows: [cond; text; speech] embeddings
    (B, T, D), their positions (B, T), the causal key-valid mask (B, T, T)
    (a row's text keys past text_lens and speech keys past speech_lens are
    masked) and the widths (lc, lt, ls) of the three parts. Reads only the
    conditioning, embedding and position leaves (a pipeline's `aux` holds
    them)."""
    ce = cond_embeds(params, cond, cfg)
    text_tokens, speech_tokens = text_tokens.long(), speech_tokens.long()
    b, lt = text_tokens.shape
    ls = speech_tokens.shape[1]
    dev = text_tokens.device
    te = L.embedding(params["text_emb"], text_tokens) + params["text_pos_emb"]["w"][:lt][None]
    se = (L.embedding(params["speech_emb"], speech_tokens)
          + params["speech_pos_emb"]["w"][:ls][None])
    x = torch.cat([ce.expand((b,) + ce.shape[1:]), te, se], dim=1)
    t = x.shape[1]
    lc = ce.shape[1]
    pos = torch.arange(t, device=dev)[None].expand(b, t)
    idx = torch.arange(t, device=dev)[None]
    causal = idx <= idx.T
    text_valid = (idx < lc) | (idx < lc + text_lens.to(dev)[:, None]) | (idx >= lc + lt)
    speech_valid = idx < lc + lt + speech_lens.to(dev)[:, None]
    key_valid = text_valid & speech_valid                          # (B, T)
    return x, pos, causal[None] & key_valid[:, None, :], (lc, lt, ls)


def _train_heads(params, h, widths, dtype):
    """(text_logits (B, Lt, V_text), speech_logits (B, Ls, V_speech)) of
    the final hidden states h, position t predicting token t from the
    position before it."""
    lc, lt, ls = widths
    return (L.linear(params["text_head"], h[:, lc - 1: lc - 1 + lt], dtype),
            L.linear(params["speech_head"], h[:, lc + lt - 1: lc + lt - 1 + ls], dtype))


def valid_targets(targets, lens) -> torch.Tensor:
    """The count of targets below each row's length, at least 1 (fp32): the
    masked cross-entropy's denominator."""
    m = torch.arange(targets.shape[1], device=targets.device)[None] < lens.to(targets.device)[:, None]
    return torch.clamp(m.sum().float(), min=1.0)


def masked_ce(logits, targets, lens, count=None):
    """The cross-entropy summed over each row's first lens targets, divided
    by `count` (default this batch's valid targets, `valid_targets`)."""
    lsm = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(lsm, -1, targets.long()[..., None])[..., 0]
    m = (torch.arange(targets.shape[1], device=ll.device)[None]
         < lens.to(ll.device)[:, None]).float()
    if count is None:
        count = valid_targets(targets, lens)
    return -torch.sum(ll * m) / count.to(ll.device)


def forward(params, cond: T3Cond, text_tokens, text_lens, speech_tokens, speech_lens,
            cfg: T3Config = T3Config(), dtype=torch.float32, remat: bool = False, mesh=None):
    """Teacher-forced forward over [cond; text; speech] (B rows), causal and
    key-valid (`_train_context`). Plain attention (llama.forward without a
    cache; `remat` checkpoints each layer; `mesh`: the params are this
    rank's Megatron shard over its tp axis). Returns (text_logits (B, Lt,
    V_text), speech_logits (B, Ls, V_speech)), where position t predicts
    token t from the position before it."""
    x, pos, mask, widths = _train_context(params, cond, text_tokens, text_lens, speech_tokens,
                                          speech_lens, cfg)
    backbone.check(cfg.llama, training=remat, mesh=mesh is not None)
    h, _ = backbone.of(cfg.llama).forward(params["llama"], x, pos, mask, cfg=cfg.llama,
                                          dtype=dtype, remat=remat, mesh=mesh)
    return _train_heads(params, h, widths, dtype)


def loss(params, cond: T3Cond, text_tokens, text_lens, speech_tokens, speech_lens,
         cfg: T3Config = T3Config(), dtype=torch.float32, remat: bool = False, mesh=None):
    """Masked cross-entropy over the text and speech streams: (loss_text,
    loss_speech), scalar fp32 tensors.

    The JAX package's objective, which departs from the reference: the
    reference computes logits at the token's own position (an off-by-one it
    inherited); this is the standard next-token shift of `forward`.

    Each stream is divided by the whole batch's count of valid targets, as
    the JAX package divides. On a mesh the arguments are the whole batch:
    each rank runs its rows over dp (`Mesh.rows`) through its tp shard, and
    divides its rows' sum by the whole batch's count (the dp sum of the
    ranks' counts, which every rank holds), so that the dp sum of the
    ranks' losses, and of their gradients, is one process's."""
    counts = (valid_targets(text_tokens, text_lens), valid_targets(speech_tokens, speech_lens))
    if mesh is not None:
        b = text_tokens.shape[0]
        r0, r1 = mesh.rows(b)
        cond = _slice_cond(cond, r0, r1, b)
        text_tokens, text_lens, speech_tokens, speech_lens = (
            x[r0:r1] for x in (text_tokens, text_lens, speech_tokens, speech_lens))
    text_logits, speech_logits = forward(params, cond, text_tokens, text_lens, speech_tokens,
                                         speech_lens, cfg, dtype, remat, mesh)
    return (masked_ce(text_logits, text_tokens, text_lens, counts[0]),
            masked_ce(speech_logits, speech_tokens, speech_lens, counts[1]))


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------

class AlignState(NamedTuple):
    """The alignment guard's per-utterance state, on the device."""
    ring: torch.Tensor          # (U, 6) int32: the last attended text positions
    complete: torch.Tensor      # (U,) bool: attention reached the text's tail
    completed_at: torch.Tensor  # (U,) int32: the step after that happened


def init_align(n_utt: int, device) -> AlignState:
    return AlignState(torch.zeros((n_utt, 6), dtype=torch.int32, device=device),
                      torch.zeros((n_utt,), dtype=torch.bool, device=device),
                      torch.zeros((n_utt,), dtype=torch.int32, device=device))


def alignment_flags(align: AlignState, i: int):
    """(force_eos, suppress_eos), each (U,) bool, at global step i: force
    on a dwell of more than 15 steps after completion or on >= 3 backward
    jumps of more than 3 positions in the ring; suppress while incomplete
    and not forced (the JAX package's decode_block.alignment_flags)."""
    long_tail = align.complete & ((i - align.completed_at) > 15)
    back = align.ring[:, 1:] < align.ring[:, :-1] - 3
    force = long_tail | (back.sum(dim=1) >= 3)
    return force, ~align.complete & ~force


def _align_logits(lg: torch.Tensor, align: AlignState, i: int, eos: int) -> torch.Tensor:
    """EOS logit surgery before sampling: a forced row keeps only EOS (0,
    every other id -1e30); a suppressed row loses EOS (-1e30)."""
    force, suppress = alignment_flags(align, i)
    eos_oh = torch.arange(lg.shape[-1], device=lg.device) == eos
    neg = torch.tensor(-1e30, dtype=lg.dtype, device=lg.device)
    forced = torch.where(eos_oh, torch.zeros((), dtype=lg.dtype, device=lg.device), neg)
    lg = torch.where(force[:, None], forced[None], lg)
    return torch.where(suppress[:, None] & eos_oh[None], neg, lg)


def _align_update(align: AlignState, arow: torch.Tensor, text_start: int,
                  text_len: torch.Tensor, i: int) -> AlignState:
    """Fold step i's spy row (B, Lc) into the state: the argmax of the
    cond rows' probabilities over each row's text span [text_start,
    text_start + text_len) is the attended position; reaching text_len - 2
    completes the row at step i + 1."""
    n_utt = text_len.shape[0]
    kidx = torch.arange(arow.shape[1], device=arow.device)
    in_text = (kidx[None] >= text_start) & (kidx[None] < text_start + text_len[:, None])
    trow = arow[:n_utt] * in_text
    trow = trow / trow.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    pos = trow.argmax(dim=-1).to(torch.int32) - text_start
    reached = pos >= text_len - 2
    newly = reached & ~align.complete
    return AlignState(torch.cat([align.ring[:, 1:], pos[:, None]], dim=1),
                      align.complete | reached,
                      torch.where(newly, torch.full_like(align.completed_at, i + 1),
                                  align.completed_at))


class DecodeState(NamedTuple):
    """A resumable decode. `cache`, `logits` and `counts` are updated in
    place by decode_block."""
    cache: llama.KVCache
    logits: torch.Tensor        # (B, V) fp32 logits at the current position
    counts: torch.Tensor        # (U, V) int32 repetition-penalty counts
    i: int                      # global step: tokens decoded so far (draw index)
    done: torch.Tensor          # (U,) bool: the row has emitted EOS
    forwards: int = 0           # decode forwards run; may pass i by the steps
                                # run between the host's EOS checks
    align: Optional[AlignState] = None   # the guard's state (prefill makes it)


def prefill(params, context, cfg: T3Config, total: int, pad_len: int,
            cfg_on: bool = True, dtype=torch.float32,
            key_valid: Optional[torch.Tensor] = None, mesh=None,
            n_utt: Optional[int] = None, kv_int8: bool = False,
            route_record: bool = False) -> DecodeState:
    """Full-context forward filling a static cache of capacity `total`;
    context (B, P, D) has `pad_len` masked junk slots on the LEFT.
    key_valid: optional (B, total) bool that also masks each row's
    right-padded text keys. mesh: the tp mesh of the params' shards (the
    rows are the caller's: this rank's, under dp). n_utt: utterances of
    the counts and done flags (default B / 2 under CFG, else B). kv_int8:
    the cache is int8 with its scale planes (models/llama.py).
    route_record: a latent backbone's cache keeps its routing record."""
    b, p_len, _ = context.shape
    dev = context.device
    bb = backbone.of(cfg.llama)
    cache = bb.init_cache(cfg.llama, b, total, torch.int8 if kv_int8 else dtype, dev,
                          heads=bb.kv_heads(params["llama"], cfg.llama), route=route_record)
    idx = torch.arange(p_len, device=dev)
    kidx = torch.arange(total, device=dev)
    causal = ((kidx[None, :] <= idx[:, None]) & (kidx[None, :] >= pad_len))[None]
    if key_valid is not None:
        causal = causal & key_valid[:, None, :]
    pos = (idx - pad_len).clamp_min(0)[None].expand(b, p_len)
    h, cache = bb.forward(params["llama"], context, pos, causal, cache=cache, cache_pos=0,
                          cfg=cfg.llama, dtype=dtype, mesh=mesh)
    logits0 = L.linear(params["speech_head"], h[:, -1], torch.float32)
    n_utt = n_utt or (b // 2 if cfg_on else b)
    counts0 = torch.zeros((n_utt, cfg.speech_tokens_dict_size), dtype=torch.int32,
                          device=dev)
    counts0[:, cfg.start_speech_token].fill_(1)
    return DecodeState(cache, logits0, counts0, 0,
                       torch.zeros((n_utt,), dtype=torch.bool, device=dev),
                       align=init_align(n_utt, dev))


_TEXT_BUCKETS = (48, 96, 192, 384, 768)
DECODE_BLOCK = 256          # the JAX package's block: sets the cache capacity
EOS_CHECK_EVERY = 32        # decode steps between host checks for EOS
CACHE_ALIGN = 256           # capacity rounding of the JAX package's kernel path
MAX_DECODE_UTTERANCES = 16  # utterances per lock-step decode (the JAX package's cap)
# share of the device's free memory that one decode's KV cache may take;
# the rest stays for prefill activations and S3Gen. At 80 GB the cap of 16
# utterances binds first (ROADMAP, slice 2).
KV_FENCE_FRACTION = 0.5


def _bucket(n: int) -> int:
    for bkt in _TEXT_BUCKETS:
        if n <= bkt:
            return bkt
    return n


def free_device_bytes(device) -> Optional[int]:
    """Free memory of a CUDA device (torch.cuda.mem_get_info); None for
    the CPU, which has no fence."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.mem_get_info(device)[0])


def kv_bytes_per_token_row(cfg: Optional[T3Config] = None, dtype=torch.bfloat16,
                           kv_int8: bool = False) -> int:
    """Bytes of KV cache one row holds for one token: k and v of every
    layer and head, L * 2 * H * D in `dtype`; an int8 cache holds L * 2 * H *
    (D + 4), its fp32 scale planes counted (the JAX package's fence leaves
    them out, ROADMAP's reference fault 3)."""
    lcfg = (cfg or T3Config()).llama
    backbone.check(lcfg, int8_cache=kv_int8)
    return backbone.of(lcfg).cache_bytes_per_token(lcfg, dtype, kv_int8)


def max_decode_utterances(cache_capacity: Optional[int] = None, *,
                          rows_per_utt: int = 2, cfg: Optional[T3Config] = None,
                          dtype=torch.bfloat16, free_bytes: Optional[int] = None,
                          kv_int8: Optional[bool] = None) -> int:
    """Utterances one lock-step decode may hold: MAX_DECODE_UTTERANCES (twice
    that for an int8 cache, as in the JAX package), and with a cache
    capacity and the device's free bytes, no more than KV_FENCE_FRACTION of
    those bytes of KV cache (rows x capacity x kv_bytes_per_token_row),
    snapped down to a power of two. rows_per_utt is 2 under CFG, 1
    otherwise. kv_int8: the cache the caller allocates (None: the
    CHATTERBOX_INT8_KV setting's)."""
    if kv_int8 is None:
        kv_int8 = llama._kv_int8_mode() > 0
    base = 2 * MAX_DECODE_UTTERANCES if kv_int8 else MAX_DECODE_UTTERANCES
    if not cache_capacity or free_bytes is None:
        return base
    per_token_row = kv_bytes_per_token_row(cfg, dtype, kv_int8)
    rows = int(free_bytes * KV_FENCE_FRACTION) // max(int(cache_capacity) * per_token_row, 1)
    utts = max(rows // max(rows_per_utt, 1), 1)
    return min(base, 1 << (utts.bit_length() - 1))


def _cfg_on(cfg_weight) -> bool:
    """CFG layout for every row if any row's weight is positive."""
    return bool(np.any(np.asarray(cfg_weight, np.float32) > 0.0))


def _capacity(lt: int, cond: T3Cond, cfg: T3Config, cfg_on: bool,
              max_new_tokens: int):
    """(pad, p_len, cap): left pad to the text bucket, context width and
    the slots the decode needs."""
    pad = min(_bucket(lt), cfg.max_text_seq_len) - lt
    p_len = pad + cond_width(cond, cfg) + lt + 1 + (1 if cfg_on else 0)
    return pad, p_len, p_len + max(max_new_tokens, DECODE_BLOCK)


def _use_fused_step() -> bool:
    """CHATTERBOX_FUSED_STEP=1 (read at call time): the decode step runs the
    whole backbone as one fused kernel (kernels/fused_decode.py, K4)."""
    return os.getenv("CHATTERBOX_FUSED_STEP", "0") == "1"


def fused_weights(params) -> bool:
    """Whether K4 can stack this backbone's wall: its linears hold "w" (an
    int8 backbone holds w_q and scale; K4 streams bf16 only, as the JAX
    package's gate at t3.py:740-741)."""
    return "w" in params["llama"]["layers"][0]["q"]


def _fused_gate(params, cfg: T3Config, n_utt: int, cfg_on: bool, alignment: bool,
                mesh) -> bool:
    """K4's gates that hold before any row is seen: the setting, no mesh,
    no guard, at most FUSED_STEP_MAX_UTTERANCES, a bf16-able backbone and
    a row count `fused_decode.plan` takes. Ragged rows turn it off later.
    A backbone without K4 raises when it is asked for."""
    backbone.check(cfg.llama, fused_step=_use_fused_step())
    return (mesh is None and _use_fused_step() and not alignment
            and n_utt <= FUSED_STEP_MAX_UTTERANCES and fused_weights(params)
            and fused_decode.plan(cfg.llama, (2 if cfg_on else 1) * n_utt) is not None)


# utterances (lock-step rows / 2 under CFG) up to which the fused step
# serves, the JAX package's CHATTERBOX_FUSED_MAX_UTT (read at import)
FUSED_STEP_MAX_UTTERANCES = int(os.getenv("CHATTERBOX_FUSED_MAX_UTT", "1"))

# the fused step's weight wall per backbone identity, built once per model:
# ~1.0 GB in bf16 at T3's width. An entry keeps a strong reference to its
# source params so the id cannot be reused while it lives.
_FUSED_STACK_CACHE: dict = {}


def _fused_params(params, cfg: T3Config, dtype):
    key = (id(params["llama"]), dtype)
    ent = _FUSED_STACK_CACHE.get(key)
    if ent is None:
        if len(_FUSED_STACK_CACHE) >= 4:
            _FUSED_STACK_CACHE.pop(next(iter(_FUSED_STACK_CACHE)))
        ent = (fused_decode.stack_for_fused(params["llama"], cfg.llama, dtype),
               params["llama"])
        _FUSED_STACK_CACHE[key] = ent
    return ent[0]


def _mesh_rows(params, cond, text_tokens, *, mesh, cfg_weight=0.0, **_):
    """A mesh call's refusal on the leader: the CFG rows (2 per utterance,
    1 without CFG) must divide dp."""
    mesh.rows(np.atleast_2d(np.asarray(text_tokens)).shape[0] * (2 if _cfg_on(cfg_weight) else 1))


# start_generation's decisions for the last decode (the JAX package's
# LAST_GENERATION_INFO): p_len, cache_total, n_utt, alignment, use_fused,
# kv_int8 and the mesh's shape (None without one)
LAST_GENERATION_INFO: dict = {}


@on_mesh(check=_mesh_rows)
def start_generation(params, cond: T3Cond, text_tokens: np.ndarray, *,
                     cfg_weight, max_new_tokens: int,
                     text_lens: Optional[np.ndarray] = None, alignment: bool = False,
                     cfg: T3Config = T3Config(), dtype=torch.float32,
                     device=None, free_bytes: Optional[int] = None, mesh=None):
    """Left-pad the text (U, T) to its bucket, build the context and
    prefill. text_lens: per-row valid lengths of right-padded rows. Raises
    above max_decode_utterances, whose fence reads `free_bytes` (default:
    the device's free memory now); generate_batch sub-batches below it.
    Returns (state, info) with the decode's p_len, pad, cfg_on,
    cache_total, the K1 hole (or None), use_fused, kv_int8,
    the fused step's weights (or None), the guard's align_layer, text_start
    and per-row text_len (None without `alignment`), the mesh and this
    rank's rows [r0, r1) of the context.

    mesh: the rows split over dp and the params are each rank's shard
    (module docstring); no fence applies. Called on the leader, the prefill
    runs on every rank and the leader's (state, info) comes back, its
    logits those of every row: a decode that follows runs inside one mesh
    call (generate, generate_batch).

    The fused step (K4) serves when CHATTERBOX_FUSED_STEP=1, at most
    FUSED_STEP_MAX_UTTERANCES utterances, a config `fused_decode.plan`
    takes, weights that are not int8, and unragged rows: its RoPE position
    is one for every row, and it attends [pad, pos] with no hole. These
    gates decide before any launch. Under `alignment` it is off: the
    guard's spy layer runs plain attention. The cache is int8 when
    CHATTERBOX_INT8_KV=1 and K4 is off; the fence counts the cache this
    decode allocates."""
    device = resolve_device(device)
    tt_np = np.atleast_2d(np.asarray(text_tokens, np.int32))
    u, lt = tt_np.shape
    if lt > cfg.max_text_seq_len:
        raise ValueError(f"text too long: {lt} tokens > max {cfg.max_text_seq_len}")
    if max_new_tokens >= cfg.max_speech_seq_len:
        # step i reads speech position max_new_tokens at most; the table has
        # max_speech_seq_len rows (an index past it is a device fault on CUDA)
        raise ValueError(f"max_new_tokens={max_new_tokens} needs more than the "
                         f"{cfg.max_speech_seq_len} speech positions")
    cfg_on = _cfg_on(cfg_weight)
    pad, p_len, cap = _capacity(lt, cond, cfg, cfg_on, max_new_tokens)
    kv_mode = llama._kv_int8_mode()
    backbone.check(cfg.llama, alignment=alignment, int8_cache=kv_mode > 0,
                   mesh=mesh is not None)
    use_fused = _fused_gate(params, cfg, u, cfg_on, alignment, mesh)
    align_layer = text_start = text_len = None
    if alignment:
        align_layer = min(ALIGNMENT_LAYER, cfg.llama.num_layers - 1)
        text_start = pad + cond_width(cond, cfg)
        lens_np = (np.asarray(text_lens, np.int32).reshape(-1) if text_lens is not None
                   else np.full((u,), lt, np.int32))
        text_len = torch.from_numpy(lens_np).to(device)
    total = -(-cap // CACHE_ALIGN) * CACHE_ALIGN
    key_valid = hole = None
    if text_lens is not None:
        lens = np.asarray(text_lens, np.int32).reshape(-1)
        if lens.shape != (u,) or lens.min() < 1 or lens.max() > lt:
            raise ValueError(f"text_lens {lens.tolist()} must give 1..{lt} for each of {u} rows")
        if (lens < lt).any():
            use_fused = False       # ragged rows need per-row key masks
            # the pad keys [ts_col + len, ts_col + lt) of each row: masked in
            # prefill, and the flash-decode kernel's per-row hole after it
            lens = torch.from_numpy(np.concatenate([lens, lens]) if cfg_on else lens).to(device)
            ts_col = pad + cond_width(cond, cfg)
            kidx = torch.arange(total, device=device)
            key_valid = ~((kidx[None] >= ts_col + lens[:, None]) & (kidx[None] < ts_col + lt))
            hole = torch.stack([ts_col + lens, torch.full_like(lens, ts_col + lt)],
                               dim=1).to(torch.int32).contiguous()
    kv_int8 = kv_mode > 0 and not use_fused
    if mesh is None:
        if free_bytes is None:
            free_bytes = free_device_bytes(device)
        cap_utt = max_decode_utterances(cap, rows_per_utt=2 if cfg_on else 1, cfg=cfg,
                                        dtype=dtype, free_bytes=free_bytes, kv_int8=kv_int8)
        if u > cap_utt:
            raise ValueError(f"{u} utterances > max_decode_utterances({cap})={cap_utt} for "
                             f"one lock-step decode; generate_batch sub-batches")
    tb = torch.from_numpy(np.pad(tt_np, ((0, 0), (pad, 0)))).to(device)
    context = _build_context(params, cond, tb, cfg, cfg_on, pad)
    rows = (0, context.shape[0])
    if mesh is not None:
        rows = mesh.rows(context.shape[0])
        context, key_valid = shard_generation_inputs(mesh, context, key_valid)
        hole = None if hole is None else hole[rows[0]:rows[1]].contiguous()
    state = prefill(params, context, cfg, total, pad, cfg_on, dtype, key_valid, mesh=mesh,
                    n_utt=u, kv_int8=kv_int8)
    if mesh is not None:
        state = state._replace(logits=mesh.gather_dp(state.logits))
    info = dict(p_len=p_len, pad=pad, cfg_on=cfg_on, cache_total=total, hole=hole,
                use_fused=use_fused, kv_int8=kv_int8,
                fused=_fused_params(params, cfg, dtype) if use_fused else None,
                align_layer=align_layer, text_start=text_start, text_len=text_len,
                mesh=mesh, rows=rows)
    LAST_GENERATION_INFO.clear()
    LAST_GENERATION_INFO.update(p_len=p_len, cache_total=total, n_utt=u,
                                alignment=align_layer is not None, use_fused=use_fused,
                                kv_int8=kv_int8,
                                mesh=None if mesh is None else dict(mesh.shape))
    return state, info


def _guided_logits(logits, counts, sp: sampling.SamplingParams, cfg_on: bool,
                   use_top_p: bool, cfg: T3Config):
    """A step's logits before the draw: the CFG mix of the [cond; uncond]
    rows, then the sampling filters (ops/sampling.process_logits)."""
    n_utt = counts.shape[0]
    if cfg_on:
        lc, lu = logits[:n_utt], logits[n_utt:]
        logits = lc + sp.cfg_weight * (lc - lu)
    return sampling.process_logits(
        logits, counts, valid_size=cfg.start_speech_token, eos_id=cfg.stop_speech_token,
        temperature=sp.temperature, repetition_penalty_val=sp.repetition_penalty,
        min_p=sp.min_p, top_p=sp.top_p, use_top_p=use_top_p)


def _token_embedding(params, tok, i: int, cfg_on: bool):
    """The next step's input: token `tok` (U,) at speech position i + 1,
    for both CFG halves when CFG is on."""
    emb = L.embedding(params["speech_emb"], tok) + params["speech_pos_emb"]["w"][i + 1][None]
    return torch.cat([emb, emb], dim=0) if cfg_on else emb


@torch.no_grad()
def decode_block(params, state: DecodeState, ginfo: dict, sp: sampling.SamplingParams,
                 draws, *, block: int, limit: int, use_top_p: bool, stop_on_eos: bool,
                 cfg: T3Config, dtype, mesh=None):
    """Decode up to `block` tokens after `state` (the JAX package's
    decode_block): a step runs while some row is not done, fewer than
    `block` steps ran and the global step state.i is below `limit`. Step i
    samples with draws.gumbel(i, ...), whatever the block size.

    The host looks for EOS at the block's start and every EOS_CHECK_EVERY
    global steps, so it may run a few steps after the last row finished;
    finished rows emit EOS there, and n_new counts as the JAX while-loop
    does (up to the step that finished the last row). The decode step is
    the fused kernel when ginfo["use_fused"], else llama.forward (K1, or
    K1s under CHATTERBOX_DEFER_KV=1). With ginfo["align_layer"] set, the
    guard's EOS surgery runs before each sample and its state takes the
    spy layer's row after each forward.

    mesh: start_generation's. Each rank forwards its rows and the logits
    (and the spy rows) are gathered over dp; every rank samples all rows.
    It runs on every rank inside one mesh call: on the leader outside one
    it raises.

    Returns (state, tokens (block, U) int32 numpy, zero past n_new, n_new).
    The state's cache, logits and counts are updated in place."""
    if mesh is not ginfo["mesh"]:
        raise ValueError("decode_block: pass the mesh that start_generation took")
    if mesh is not None and mesh.leads():
        raise ValueError("decode_block on a mesh runs inside a mesh call (t3.generate, "
                         "t3.generate_batch), where every rank holds its state")
    r0, r1 = ginfo["rows"]
    p_len, pad_len, cfg_on = ginfo["p_len"], ginfo["pad"], ginfo["cfg_on"]
    cache, logits, counts, i0, done0 = state.cache, state.logits, state.counts, state.i, state.done
    align_layer, align = ginfo["align_layer"], state.align
    n_utt = counts.shape[0]
    eos = cfg.stop_speech_token
    dev = logits.device
    rows = torch.arange(n_utt, device=dev)
    done = done0
    toks = []
    for j in range(block):
        i = i0 + j
        if i >= limit:
            break
        if stop_on_eos and (j == 0 or i % EOS_CHECK_EVERY == 0) and bool(done.all()):
            break
        lg = _guided_logits(logits, counts, sp, cfg_on, use_top_p, cfg)
        if align_layer is not None:
            lg = _align_logits(lg, align, i, eos)
        tok = sampling.sample_token(lg, draws.gumbel(i, tuple(lg.shape)).to(dev))
        tok = torch.where(done, torch.full_like(tok, eos), tok)  # finished rows emit EOS
        toks.append(tok)
        counts[rows, tok] += 1
        if stop_on_eos:
            done = done | (tok == eos)
        emb = _token_embedding(params, tok, i, cfg_on)[r0:r1]
        if ginfo["use_fused"]:
            hh, _, _ = fused_decode.fused_decode_step(
                ginfo["fused"], emb.to(dtype), cache.k, cache.v, p_len + i, pad_len,
                cfg.llama, dtype)
        else:
            pos_id = torch.full((r1 - r0, 1), p_len - pad_len + i, dtype=torch.int64,
                                device=dev)
            out = backbone.of(cfg.llama).forward(
                params["llama"], emb[:, None, :].to(dtype), pos_id, cache=cache,
                cache_pos=p_len + i, cfg=cfg.llama, dtype=dtype, flash_start=pad_len,
                flash_hole=ginfo["hole"], collect_attn_layer=align_layer, mesh=mesh)
            hh, cache = out[0][:, -1], out[1]
            if align_layer is not None:
                arow = out[2] if mesh is None else mesh.gather_dp(out[2])
                align = _align_update(align, arow, ginfo["text_start"], ginfo["text_len"], i)
        logits = L.linear(params["speech_head"], hh, torch.float32)
        if mesh is not None:
            logits = mesh.gather_dp(logits)
    steps = len(toks)
    tok_np = (torch.stack(toks).cpu().numpy().astype(np.int32) if steps
              else np.zeros((0, n_utt), np.int32))
    n_new = steps
    if stop_on_eos and steps:
        fin = done0.cpu().numpy()[None] | np.logical_or.accumulate(tok_np == eos, axis=0)
        hit = np.nonzero(fin.all(axis=1))[0]
        if hit.size:
            n_new = int(hit[0]) + 1
    out = np.zeros((block, n_utt), np.int32)
    out[:n_new] = tok_np[:n_new]
    return (DecodeState(cache, logits, counts, i0 + n_new, done, state.forwards + steps, align),
            out, n_new)


@torch.no_grad()
def decode_fixed_block(params, state: DecodeState, ginfo: dict, sp: sampling.SamplingParams,
                       draws, *, block: int, limit: torch.Tensor, use_top_p: bool,
                       cfg: T3Config, dtype):
    """The JAX package's decode_block with EOS stopping, as `block` fixed
    steps that never wait on the host, so that a CUDA graph can capture
    them (the stream's first chunk, streaming.py). Step j of the block
    (global step i = state.i + j, state.i a python int) is active while
    some row is not done and i < limit (a device int); an inactive step
    still runs, and its sample, counts, done flags and logits are dropped,
    as the JAX while-loop never runs it. Finished rows emit EOS. The cache
    position of step j is p_len + i whatever came before it, so an
    inactive step writes only slots past the last active one.
    ginfo["pad"] may be a one-element int32 tensor on the device: the
    position ids, K1's start and K4's start then read it there. One
    utterance layout as start_generation's without a mesh, a hole or the
    guard.

    Returns (state, tokens (block, U) int32, zero past n_new, n_new ()
    int32), all on the device; state.i is then the device count
    state.i + n_new and state.forwards has `block` more."""
    p_len, pad, cfg_on = ginfo["p_len"], ginfo["pad"], ginfo["cfg_on"]
    if ginfo["mesh"] is not None or ginfo["hole"] is not None or ginfo["align_layer"] is not None:
        raise ValueError("decode_fixed_block: no mesh, hole or alignment guard")
    cache, logits, counts, i0, done = state.cache, state.logits, state.counts, state.i, state.done
    n_utt = counts.shape[0]
    eos = cfg.stop_speech_token
    dev = logits.device
    rows = torch.arange(n_utt, device=dev)
    n_new = torch.zeros((), dtype=torch.int32, device=dev)
    toks = []
    for j in range(block):
        i = i0 + j
        active = ~done.all() & (limit > i)
        lg = _guided_logits(logits, counts, sp, cfg_on, use_top_p, cfg)
        tok = sampling.sample_token(lg, draws.gumbel(i, tuple(lg.shape)).to(dev))
        tok = torch.where(done, torch.full_like(tok, eos), tok)
        toks.append(tok)
        counts[rows, tok] += active.to(counts.dtype)
        done = done | (active & (tok == eos))
        n_new = n_new + active.to(n_new.dtype)
        emb = _token_embedding(params, tok, i, cfg_on)
        if ginfo["use_fused"]:
            hh, _, _ = fused_decode.fused_decode_step(
                ginfo["fused"], emb.to(dtype), cache.k, cache.v, p_len + i, pad, cfg.llama,
                dtype)
        else:
            pos_id = (p_len + i - pad).reshape(1, 1).expand(emb.shape[0], 1).long()
            hh, cache = llama.forward(params["llama"], emb[:, None, :].to(dtype), pos_id,
                                      cache=cache, cache_pos=p_len + i, cfg=cfg.llama,
                                      dtype=dtype, flash_start=pad)
            hh = hh[:, -1]
        logits = torch.where(active, L.linear(params["speech_head"], hh, torch.float32), logits)
    tokens = torch.stack(toks).to(torch.int32)
    tokens = torch.where(torch.arange(block, device=dev)[:, None] < n_new, tokens,
                         torch.zeros_like(tokens))
    return (DecodeState(cache, logits, counts, i0 + n_new, done, state.forwards + block,
                        state.align), tokens, n_new)


def _stream_rows(params, cond: T3Cond, text_tokens, text_lens, draws, temperature,
                 cfg_weight, repetition_penalty, min_p, top_p, *, max_new_tokens: int,
                 stop_on_eos: bool, block: int, cfg: T3Config, dtype, device,
                 free_bytes, info: Optional[dict], alignment: bool = False, mesh=None):
    """Prefill one lock-step batch of U rows and yield (n, U) int32 token
    blocks as they decode (the JAX package's generate_stream loop). `info`,
    if given, receives start_generation's info (without the weights) and
    decode_steps, the decode forwards run so far, before each yield."""
    n_utt = np.atleast_2d(text_tokens).shape[0]
    state, ginfo = start_generation(params, cond, text_tokens, cfg_weight=cfg_weight,
                                    max_new_tokens=max_new_tokens, text_lens=text_lens,
                                    alignment=alignment, cfg=cfg, dtype=dtype, device=device,
                                    free_bytes=free_bytes, mesh=mesh)
    sp = sampling.SamplingParams(*(sampling.sampling_param(v, n_utt, device) for v in (
        temperature, cfg_weight, repetition_penalty, min_p, top_p)))
    use_top_p = bool(np.any(np.asarray(top_p, np.float32) < 1.0))
    if info is not None:
        info.update({k: v for k, v in ginfo.items() if k not in ("fused", "mesh")},
                    decode_steps=0)
    produced = 0
    while produced < max_new_tokens:
        state, tokens, n = decode_block(params, state, ginfo, sp, draws, block=block,
                                        limit=max_new_tokens, use_top_p=use_top_p,
                                        stop_on_eos=stop_on_eos, cfg=cfg, dtype=dtype,
                                        mesh=mesh)
        if info is not None:
            info["decode_steps"] = state.forwards
        if n > 0:
            yield tokens[:n]
        produced += n
        if n == 0 or bool(state.done.all()):
            break


def _generate_rows(params, cond: T3Cond, text_tokens, text_lens, draws, temperature,
                   cfg_weight, repetition_penalty, min_p, top_p, *, max_new_tokens: int,
                   stop_on_eos: bool, cfg: T3Config, dtype, device, free_bytes,
                   alignment: bool = False, mesh=None):
    """Prefill and decode one lock-step batch of U rows. Returns (tokens
    (steps, U) int32 numpy, info of start_generation plus decode_steps)."""
    info: dict = {}
    blocks = list(_stream_rows(
        params, cond, text_tokens, text_lens, draws, temperature, cfg_weight,
        repetition_penalty, min_p, top_p, max_new_tokens=max_new_tokens,
        stop_on_eos=stop_on_eos, block=DECODE_BLOCK, cfg=cfg, dtype=dtype, device=device,
        free_bytes=free_bytes, info=info, alignment=alignment, mesh=mesh))
    n_utt = np.atleast_2d(text_tokens).shape[0]
    tokens = np.concatenate(blocks) if blocks else np.zeros((0, n_utt), np.int32)
    return tokens, info


@torch.no_grad()
def generate_stream(params, cond: T3Cond, text_tokens: np.ndarray, *,
                    max_new_tokens: int = 1000, temperature=0.8, cfg_weight=0.0,
                    repetition_penalty=1.2, min_p=0.05, top_p=1.0,
                    stop_on_eos: bool = True, seed: int = 0, block: int = DECODE_BLOCK,
                    text_lens: Optional[np.ndarray] = None, draws=None,
                    alignment: bool = False, cfg: T3Config = T3Config(),
                    dtype=torch.float32, device=None, info: Optional[dict] = None):
    """Yield numpy blocks of generated speech-token ids as they decode,
    `block` steps at a time: (n,) for one utterance, (n, U) for more. The
    final block includes the terminating EOS when one is produced.

    draws: the Gumbel source (`sampling.Draws(seed, device)` by default).
    alignment: the alignment guard (module docstring).
    info: optional dict that receives p_len, pad, cache_total, use_fused and
    decode_steps (the decode forwards run so far)."""
    device = resolve_device(device)
    single = np.atleast_2d(text_tokens).shape[0] == 1
    draws = draws if draws is not None else sampling.Draws(seed, device)
    for blk in _stream_rows(params, cond, text_tokens, text_lens, draws, temperature,
                            cfg_weight, repetition_penalty, min_p, top_p,
                            max_new_tokens=max_new_tokens, stop_on_eos=stop_on_eos,
                            block=block, cfg=cfg, dtype=dtype, device=device,
                            free_bytes=None, info=info, alignment=alignment):
        yield blk[:, 0] if single else blk


@on_mesh(check=_mesh_rows)
@torch.no_grad()
def generate(params, cond: T3Cond, text_tokens: np.ndarray, *,
             max_new_tokens: int = 1000, temperature: float = 0.8,
             cfg_weight: float = 0.0, repetition_penalty: float = 1.2,
             min_p: float = 0.05, top_p: float = 1.0, stop_on_eos: bool = True,
             seed: int = 0, draws=None, alignment: bool = False,
             cfg: T3Config = T3Config(), dtype=torch.float32, device=None,
             info: Optional[dict] = None, mesh=None) -> np.ndarray:
    """Speech tokens for one utterance. text_tokens: (1, T) wrapped in
    SOT/EOT. Returns the generated ids INCLUDING the terminating EOS if one
    was produced.

    draws: the Gumbel source (`sampling.Draws(seed, device)` by default).
    alignment: the alignment guard (module docstring).
    info: optional dict that receives p_len, pad, cache_total, use_fused and
    decode_steps (the number of decode forwards run); on a mesh, the
    leader's.
    mesh: the params are each rank's shard (parallel.serve.
    shard_t3_for_serving); the CFG rows split over dp. Every rank draws
    the same noise: `draws` goes to each of them as it is here."""
    if np.atleast_2d(text_tokens).shape[0] != 1:
        raise ValueError("generate decodes one utterance; generate_batch takes more")
    device = resolve_device(device)
    draws = draws if draws is not None else sampling.Draws(seed, device)
    tokens, ginfo = _generate_rows(
        params, cond, text_tokens, None, draws, temperature, cfg_weight,
        repetition_penalty, min_p, top_p, max_new_tokens=max_new_tokens,
        stop_on_eos=stop_on_eos, cfg=cfg, dtype=dtype, device=device, free_bytes=None,
        alignment=alignment, mesh=mesh)
    out = tokens[:, 0]
    eos_at = np.nonzero(out == cfg.stop_speech_token)[0]
    if stop_on_eos and eos_at.size:
        out = out[: int(eos_at[0]) + 1]
    if info is not None:
        info.update(ginfo)
    return out


def _slice_cond(cond: T3Cond, s0: int, s1: int, n_utt: int) -> T3Cond:
    """The conditioning of utterances [s0, s1): per-row fields (U rows)
    are sliced, shared ones (1 row, scalar emotion) kept."""
    emo = cond.emotion_adv
    if torch.is_tensor(emo) and emo.numel() == n_utt:
        emo = emo.reshape(-1)[s0:s1]
    spk = cond.speaker_emb
    if spk.dim() >= 2 and spk.shape[0] == n_utt:
        spk = spk[s0:s1]
    cps = cond.cond_prompt_speech_tokens
    if cps is not None and cps.shape[0] == n_utt:
        cps = cps[s0:s1]
    return T3Cond(spk, cps, emo)


def _slice_param(value, s0: int, s1: int):
    a = np.asarray(value, np.float32)
    return value if a.ndim == 0 else a[s0:s1]


@on_mesh(check=_mesh_rows)
@torch.no_grad()
def generate_batch(params, cond: T3Cond, text_tokens: np.ndarray, *,
                   max_new_tokens: int = 1000, temperature=0.8, cfg_weight=0.0,
                   repetition_penalty=1.2, min_p=0.05, top_p=1.0,
                   stop_on_eos: bool = True, seed: int = 0,
                   text_lens: Optional[np.ndarray] = None,
                   make_draws: Optional[Callable[[int], object]] = None,
                   alignment: bool = False, cfg: T3Config = T3Config(),
                   dtype=torch.float32, device=None, free_bytes: Optional[int] = None,
                   info: Optional[dict] = None, mesh=None) -> list:
    """Speech tokens for U utterances decoded in lock-step, with per-row
    sampling and EOS. text_tokens (U, T) are right-padded to a common width
    with valid lengths `text_lens`. Returns a list of U 1-D id arrays, each
    cut after its first EOS (EOS included).

    temperature, cfg_weight, repetition_penalty, min_p and top_p are each
    one scalar for every row or a length-U sequence. `cond` is one voice
    (1 row) or one per utterance (U rows), with a scalar or (U,) emotion.

    Above max_decode_utterances (sized against the cache the batch's gates
    give: int8 under CHATTERBOX_INT8_KV=1 unless K4 takes it) the rows
    decode in sequential sub-batches;
    sub-batch [s0, s1) samples with seed + s0 from `make_draws(seed + s0)`
    (default `sampling.Draws(seed + s0, device)`). The fence reads
    `free_bytes` (default: the device's free memory, read once).
    alignment: the alignment guard (module docstring), with each row's own
    text length. info: optional dict that receives decode_steps (summed
    over sub-batches), sub_batches and sub_batch_utts.

    mesh: as `generate`; the CFG rows (2U) split over dp and must divide
    it, and the batch decodes in one piece (no fence, as the JAX package),
    drawing from make_draws(seed) on every rank."""
    device = resolve_device(device)
    tt = np.atleast_2d(np.asarray(text_tokens, np.int32))
    n_utt, lt = tt.shape
    make_draws = make_draws or functools.partial(sampling.Draws, device=device)
    cfg_on = _cfg_on(cfg_weight)
    if mesh is not None:
        cap_utt = n_utt
    else:
        if free_bytes is None:
            free_bytes = free_device_bytes(device)
        cap = _capacity(lt, cond, cfg, cfg_on, max_new_tokens)[2]
        kv_int8 = (llama._kv_int8_mode() > 0
                   and not _fused_gate(params, cfg, n_utt, cfg_on, alignment, None))
        cap_utt = max_decode_utterances(cap, rows_per_utt=2 if cfg_on else 1, cfg=cfg,
                                        dtype=dtype, free_bytes=free_bytes, kv_int8=kv_int8)
    outs, steps = [], 0
    for s0 in range(0, n_utt, cap_utt):
        s1 = min(n_utt, s0 + cap_utt)
        tokens, ginfo = _generate_rows(
            params, _slice_cond(cond, s0, s1, n_utt), tt[s0:s1],
            None if text_lens is None else np.asarray(text_lens)[s0:s1],
            make_draws(seed + s0),
            *(_slice_param(v, s0, s1) for v in (temperature, cfg_weight,
                                                repetition_penalty, min_p, top_p)),
            max_new_tokens=max_new_tokens, stop_on_eos=stop_on_eos, cfg=cfg,
            dtype=dtype, device=device, free_bytes=free_bytes, alignment=alignment, mesh=mesh)
        steps += ginfo["decode_steps"]
        for col in range(s1 - s0):
            seq = tokens[:, col]
            eos_at = np.nonzero(seq == cfg.stop_speech_token)[0]
            outs.append(seq[: int(eos_at[0]) + 1] if eos_at.size else seq)
    if info is not None:
        info.update(decode_steps=steps, sub_batches=-(-n_utt // cap_utt),
                    sub_batch_utts=cap_utt)
    return outs
