"""Continuous-batching T3 decode engine (slot-refill decoding), the PyTorch
counterpart of `chatterbox_embed_tpu/models/t3_engine.py`.

A fixed set of S decode slots stays hot: each holds one in-flight request,
rows advance at their own depths, and when a row finishes the host prefills
a queued request into the freed slot between blocks. B = 2S rows in the CFG
layout [cond rows 0..S-1; uncond rows S..2S-1], as t3.decode_block.

- The cache is the JAX engine's ring-column layout: every slot's context
  occupies columns [pad, p_len) of its rows; the generated region [p_len,
  p_len + R) is a ring indexed by the global engine step g, and every step
  writes the one shared column p_len + (g mod R) for all rows (the
  lock-step insert at a scalar cache_pos). A slot that joined at step gs
  and is live at step g owns the ring columns written at steps [gs, g],
  which never wrap onto themselves (g - gs < R, the engine's token cap).
- Each step attends through the flash-decode kernel (K1) with a per-row
  span and hole (`engine_spans`): the slot's context [pad, p_len) plus its
  ring columns, which is the JAX engine's ws mask written as one range and
  one hole a row. Rows of free or finished slots get an empty span (K1
  writes 0; their outputs are never used). The spans come from the slots'
  pad and join step on the device and the host's step counter, so a step
  reads nothing back but the one `done.all()` that ends the block where
  the JAX while-loop ends it. The engine takes K1 whatever
  CHATTERBOX_DEFER_KV says, never the fused step (K4), and ignores
  CHATTERBOX_ALIGNMENT, as the JAX engine composes no kernel and no spy.
- Draws: each request samples step i with draws.gumbel(i, (V,)) from its
  own source `make_draws(seed)`, so its tokens do not depend on its slot or
  on the traffic around it (the JAX engine's fold_in(PRNGKey(seed), i)).
- The cache is in the compute dtype, or int8 with its scale planes
  (`kv_int8=True`, or None and CHATTERBOX_INT8_KV=1, as the JAX engine):
  a request's prefill quantises its context, the insert copies its slabs
  and scales, each step's ring column is quantised as it is written, and
  K1's int8 entry walks the spans.
- Off a mesh the step runs in pieces (`EngineStep`, `pieced_decode_block`)
  on the capture driver (utils/graphs.py). On the card the first block's
  first step warms the pieces up and captures them as CUDA graphs, and
  every later step replays them; elsewhere the pieces are called as they
  are. Llama's step is cut at K1, which runs eagerly between the pieces,
  so a step costs the host ~200 launches instead of ~1,600. A mesh takes
  the step whole (`engine_decode_block`): a graph cannot hold its
  collectives.
- A latent backbone (models/deepseek_v2.py, DeepSeek-V2) keeps a latent
  cache (layers, total, 2S', 576) in the same ring-column layout, and its
  step has no eager kernel between its parts: off a mesh it is one piece,
  one CUDA graph on the card, the step's keys the same spans and holes as
  a mask and its routed experts through K7. With `route_record` the cache
  also keeps every row's expert ids at each column (`LatentCache.route`),
  and the decoder copies a finished request's ids to the host at the end
  of the block (`ContinuousDecoder.routes`). Its int8 cache and the mesh
  raise (`backbone.check`). Which step a backbone takes is its module's
  `WHOLE_STEP` (models/backbone.py).
- On a mesh (`mesh=`, parallel/): `engine_slots` is the JAX package's
  engine_sharding rule. Under dp each rank owns S/dp slots, both CFG rows
  of each, and holds their cache rows and logits; it prefills only the
  requests that land in its slots. The host scheduler and the per-slot
  bookkeeping (counts, steps, done flags, draws) run the same on every
  rank: the rows' logits are gathered over dp once a step and every rank
  samples every slot, so the tokens are the same everywhere. A tp-only
  mesh replicates the slots; tp splits the backbone as in the lock-step
  decode. The decoder is built on every rank (`Mesh.adopt`) and its
  `submit`, `step` and `drain` called on the leader run on every rank.

The engine state is updated in place (the JAX package donates it).
"""
from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import T3Config
from ..device import resolve_device
from ..ops import sampling
from ..parallel.mesh import on_mesh_method
from ..utils import graphs, profiling
from . import backbone
from . import layers as L
from . import llama
from . import t3


@dataclass
class EngineState:
    """The state of an S-slot engine. Device tensors (updated in place):
    the ring-column cache, the rows' logits, each slot's repetition counts,
    tokens generated, done flag, left pad, join step, limit and sampling
    parameters. Host values: the global step `g`, each slot's join step
    and draw source (None for a free slot), and the slots [s0, s1) whose
    rows this rank holds (all of them off a dp mesh): the cache and the
    logits hold rows [cond of s0..s1-1; uncond of s0..s1-1]."""
    cache: llama.KVCache          # (L, total, 2S', H, D) sequence-major, S' = s1 - s0,
                                  # or a latent backbone's LatentCache
    logits: torch.Tensor          # (2S', V) fp32
    counts: torch.Tensor          # (S, V) int32
    fresh_counts: torch.Tensor    # (V,) int32: a new request's counts (BOS once)
    i: torch.Tensor               # (S,) int64 tokens generated per slot
    done: torch.Tensor            # (S,) bool: free or finished
    pad: torch.Tensor             # (S,) int64 left pad of the slot's context
    g_start: torch.Tensor         # (S,) int64 the occupant's join step
    limit: torch.Tensor           # (S,) int64 the request's max_new_tokens
    temperature: torch.Tensor     # (S, 1) fp32
    cfg_weight: torch.Tensor      # (S, 1)
    rep_penalty: torch.Tensor     # (S, 1)
    min_p: torch.Tensor           # (S, 1)
    top_p: torch.Tensor           # (S, 1)
    g: int = 0                    # global engine step
    g_start_host: List[int] = field(default_factory=list)
    draws: List[object] = field(default_factory=list)
    own: tuple = (0, 0)


def engine_slots(mesh, slots: int) -> tuple:
    """The slots [s0, s1) this rank holds on `mesh` (the JAX package's
    engine_sharding): S/dp of them under dp, all on a tp-only mesh or
    without one. Slots that do not divide dp raise."""
    dp = 1 if mesh is None else mesh.dp
    if dp == 1:
        return 0, slots
    if slots % dp != 0:
        raise ValueError(
            f"{slots} engine slots do not divide the dp axis ({dp} "
            "devices); pick WORKER_SLOTS / ContinuousServer slots as a "
            "multiple of dp")
    per = slots // dp
    return mesh.dp_index * per, (mesh.dp_index + 1) * per


def engine_geometry(cfg: T3Config, text_bucket: int, cond_w: int, max_new_tokens: int):
    """(p_len, total): the context width and cache capacity every slot
    shares. A slot's context is [pad junk; cond; text; BOS; BOS]: CFG is
    always on."""
    p_len = text_bucket + cond_w + 2
    return p_len, p_len + max_new_tokens


def engine_init(cfg: T3Config, *, slots: int, text_bucket: int, cond_w: int,
                max_new_tokens: int, dtype=torch.float32, device=None,
                own: Optional[tuple] = None, heads: Optional[int] = None,
                kv_int8: bool = False, route_record: bool = False) -> EngineState:
    """All-free engine state on `device` (None: the card): every slot done,
    with pad = p_len. The cache has the compute dtype, or is int8 with its
    scale planes (`kv_int8`). own: the slots [s0, s1) whose rows this rank
    holds (default all); heads: its K/V heads (default all,
    llama.init_cache). A latent backbone's cache is a LatentCache, with its
    routing record under `route_record`."""
    device = resolve_device(device)
    p_len, total = engine_geometry(cfg, text_bucket, cond_w, max_new_tokens)
    if max_new_tokens + 2 > cfg.max_speech_seq_len:
        # a finished row reads speech position limit + 1 (it stops
        # advancing there); the table has max_speech_seq_len rows
        raise ValueError(f"max_new_tokens={max_new_tokens} needs more than the "
                         f"{cfg.max_speech_seq_len} speech positions")
    s, v = slots, cfg.speech_tokens_dict_size
    own = own or (0, s)
    mine = own[1] - own[0]

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    return EngineState(
        cache=backbone.of(cfg.llama).init_cache(cfg.llama, 2 * mine, total,
                                                torch.int8 if kv_int8 else dtype, device,
                                                heads=heads, route=route_record),
        logits=full((2 * mine, v), 0.0, torch.float32),
        counts=full((s, v), 0, torch.int32),
        fresh_counts=torch.nn.functional.one_hot(
            torch.tensor(cfg.start_speech_token, device=device), v).to(torch.int32),
        i=full((s,), 0, torch.int64), done=full((s,), True, torch.bool),
        pad=full((s,), p_len, torch.int64), g_start=full((s,), 0, torch.int64),
        limit=full((s,), 0, torch.int64),
        temperature=full((s, 1), 1.0, torch.float32),
        cfg_weight=full((s, 1), 0.0, torch.float32),
        rep_penalty=full((s, 1), 1.0, torch.float32),
        min_p=full((s, 1), 0.0, torch.float32), top_p=full((s, 1), 1.0, torch.float32),
        g=0, g_start_host=[0] * s, draws=[None] * s, own=own)


def engine_spans(pad: torch.Tensor, g_start: torch.Tensor, dead: torch.Tensor, g: int,
                 p_len: int, ring: int):
    """K1's per-row span and hole at global step g for S slots: each (2S,
    2) int32, the slots' rows twice (cond, then uncond).

    A live slot that joined at step gs (a = gs mod R) owns its context
    [pad, p_len) and the ring columns written at steps [gs, g], which are
    p_len + a ... p_len + c in ring order, c = g mod R:
      no wrap (a <= c): span [pad, p_len + c], hole [p_len, p_len + a)
      wrap (a > c):     span [pad, p_len + R - 1], hole [p_len + c + 1, p_len + a)
    (at a = c + 1, the full ring, the hole is empty). That is the JAX
    engine's mask `(k >= pad & k < p_len) | (ws[k] in [gs, gs + i])` for a
    row with i = g - gs. A `dead` slot (free or finished) gets the empty
    span [1, 0]."""
    c = g % ring
    a = torch.remainder(g_start, ring)
    wrap = a > c
    hi = torch.where(wrap, torch.full_like(a, p_len + ring - 1), torch.full_like(a, p_len + c))
    hole_lo = torch.where(wrap, torch.full_like(a, p_len + c + 1), torch.full_like(a, p_len))
    span = torch.stack([torch.where(dead, torch.ones_like(pad), pad),
                        torch.where(dead, torch.zeros_like(hi), hi)], dim=1)
    hole = torch.stack([hole_lo, p_len + a], dim=1)
    return (torch.cat([span, span]).to(torch.int32).contiguous(),
            torch.cat([hole, hole]).to(torch.int32).contiguous())


@torch.no_grad()
def prefill_request(params, cond: t3.T3Cond, text_tokens: np.ndarray, *, text_bucket: int,
                    p_len: int, cfg: T3Config, dtype=torch.float32, device=None, mesh=None,
                    kv_int8: bool = False, route_record: bool = False):
    """Prefill ONE request's 2 CFG rows into a p_len-capacity DecodeState
    (t3._build_context and t3.prefill, left-padded to the engine's text
    bucket; `mesh`: the tp ranks of the params' shards; `kv_int8`: an int8
    cache; `route_record`: a latent cache's routing record). Returns
    (state, pad)."""
    device = resolve_device(device)
    tt = np.atleast_2d(np.asarray(text_tokens, np.int32))
    if tt.shape[0] != 1:
        raise ValueError("engine requests are single utterances")
    lt = tt.shape[1]
    if lt > text_bucket:
        raise ValueError(f"text ({lt} tokens) exceeds engine bucket {text_bucket}")
    pad = text_bucket - lt
    tb = torch.from_numpy(np.pad(tt, ((0, 0), (pad, 0)))).to(device)
    context = t3._build_context(params, cond, tb, cfg, True, pad)
    return t3.prefill(params, context, cfg, p_len, pad, True, dtype, mesh=mesh,
                      kv_int8=kv_int8, route_record=route_record), pad


@torch.no_grad()
def engine_insert(state: EngineState, sub: t3.DecodeState, slot: int, draws,
                  meta: Dict[str, float]) -> None:
    """Put a prefilled request (prefill_request's state, capacity p_len)
    into slot `slot`, in place: its cache columns [0, p_len) of the slot's
    cond and uncond rows (and of an int8 cache's scale planes, or a latent
    cache's routing record), their logits, its counts and sampling
    parameters, and its join step g. meta: limit, pad, temperature, cfg_weight,
    repetition_penalty, min_p, top_p. Every write takes a host scalar or a
    device tensor; no copy waits for the device. A rank that does not hold
    the slot's rows passes sub None and keeps only the bookkeeping."""
    s0, s1 = state.own
    if sub is not None:
        p_len = sub.cache[0].shape[1]
        pairs = list(zip(state.cache, sub.cache))      # k, v (, k_scale, v_scale)
        for half, row in enumerate((slot - s0, s1 - s0 + slot - s0)):
            for dst, src in pairs:
                if dst is not None:
                    dst[:, :p_len, row] = src[:, :, half]
            state.logits[row] = sub.logits[half]
    state.counts[slot] = state.fresh_counts           # prefill's counts: BOS once
    state.i[slot] = 0
    state.done[slot] = False
    state.pad[slot] = int(meta["pad"])
    state.limit[slot] = int(meta["limit"])
    state.g_start[slot] = state.g
    for name in ("temperature", "cfg_weight", "rep_penalty", "min_p", "top_p"):
        getattr(state, name)[slot, 0] = float(meta[name])
    state.g_start_host[slot] = state.g
    state.draws[slot] = draws


def _step_noise(state: EngineState, g: int, zeros, out: torch.Tensor) -> None:
    """Step g's Gumbel rows into `out` (S, V): each occupied slot's from
    its own draw source at its own step g - gs, zeros for a free slot."""
    with profiling.span("engine.noise"):
        v = out.shape[1]
        torch.stack([zeros if d is None else d.gumbel(g - gs, (v,)).to(out.device)
                     for d, gs in zip(state.draws, state.g_start_host)], out=out)


def _sample(state: EngineState, logits, noise, cfg: T3Config, use_top_p: bool):
    """One step's sampling from the rows' logits (2S, V), [cond; uncond] of
    every slot: the CFG combine through the per-slot sampling parameters,
    the Gumbel draw on `noise` (S, V), EOS for a finished slot, the counts
    (in place). Returns (tokens (S,), the new done flags)."""
    s_slots = state.done.shape[0]
    eos = cfg.stop_speech_token
    lc, lu = logits[:s_slots], logits[s_slots:]
    lg = sampling.process_logits(
        lc + state.cfg_weight * (lc - lu), state.counts, valid_size=cfg.start_speech_token,
        eos_id=eos, temperature=state.temperature, repetition_penalty_val=state.rep_penalty,
        min_p=state.min_p, top_p=state.top_p, use_top_p=use_top_p)
    tok = sampling.sample_token(lg, noise)
    tok = torch.where(state.done, torch.full_like(tok, eos), tok)
    state.counts.scatter_add_(1, tok[:, None], torch.ones_like(state.counts[:, :1]))
    return tok, state.done | (tok == eos) | (state.i + 1 >= state.limit)


def _next_input(params, state: EngineState, tok, p_len: int, dtype):
    """A step's input rows, [cond; uncond] of every slot: each slot's token
    embedding plus its next speech position (2S, 1, D) in `dtype`, and its
    RoPE position p_len - pad + i (2S, 1)."""
    emb = L.embedding(params["speech_emb"], tok) + params["speech_pos_emb"]["w"][state.i + 1]
    pos_id = (p_len - state.pad + state.i)[:, None]
    return torch.cat([emb, emb])[:, None].to(dtype), torch.cat([pos_id, pos_id])


def _close_step(params, state: EngineState, h, done) -> None:
    """The speech head on the backbone's last rows `h` into state.logits,
    then each live slot's count of tokens and the new done flags, in
    place."""
    state.logits.copy_(L.linear(params["speech_head"], h[:, -1], torch.float32))
    state.i.copy_(torch.where(state.done, state.i, state.i + 1))
    state.done.copy_(done)


@torch.no_grad()
def engine_decode_block(params, state: EngineState, cfg: T3Config, block: int, p_len: int,
                        use_top_p: bool, dtype=torch.float32, mesh=None):
    """Decode up to `block` tokens on every live slot, in place; stops
    before a step when every slot is done (the JAX while-loop's condition,
    read with one `done.all()` a step). Returns (tokens (block, S) int32
    numpy, EOS past the steps run; n_steps).

    The JAX engine's body, step by step: CFG-combined logits through the
    per-slot sampling parameters; each slot's Gumbel noise from its own
    draw source at its own step g - gs (zeros for a free slot); a finished
    slot emits EOS and stops advancing; one forward of all 2S rows at their
    own RoPE positions p_len - pad + i, inserting at the shared ring column
    and attending through K1 with `engine_spans`.

    mesh: each rank forwards the rows of its slots (state.own) and the
    logits are gathered over dp before each step's sampling. Off a mesh
    the engine takes the same step in pieces (`EngineStep`,
    `pieced_decode_block`); a latent backbone's step here is the eager one
    its piece is held to (it runs on no mesh)."""
    s_slots = state.done.shape[0]
    s0, s1 = state.own
    local = None                                      # this rank's rows of the 2S
    if (s0, s1) != (0, s_slots):
        mine = torch.arange(s0, s1, device=state.logits.device)
        local = torch.cat([mine, s_slots + mine])

    def ours(x):
        return x if local is None else x[local].contiguous()

    dev = state.logits.device
    v = cfg.speech_tokens_dict_size
    total = state.cache[0].shape[1]
    ring = total - p_len
    zeros = torch.zeros((v,), dtype=torch.float32, device=dev)
    noise = torch.empty((s_slots, v), dtype=torch.float32, device=dev)
    toks = []
    for _ in range(block):
        with profiling.span("engine.done_read"):
            all_done = bool(state.done.all())
        if all_done:
            break
        with profiling.span("engine.sample"):
            logits = state.logits
            if mesh is not None and mesh.dp > 1:
                # (dp x [cond; uncond] of each rank's slots) -> [cond; uncond] of all
                logits = mesh.gather_dp(logits).view(mesh.dp, 2, s1 - s0, v).transpose(0, 1)
                logits = logits.reshape(2 * s_slots, v)
            _step_noise(state, state.g, zeros, noise)
            tok, done = _sample(state, logits, noise, cfg, use_top_p)
            toks.append(tok)
        with profiling.span("engine.forward"):
            emb, pos_id = _next_input(params, state, tok, p_len, dtype)
            span, hole = engine_spans(state.pad, state.g_start, done, state.g, p_len, ring)
            hh, _ = backbone.of(cfg.llama).forward(
                params["llama"], ours(emb), ours(pos_id), cache=state.cache,
                cache_pos=p_len + state.g % ring, cfg=cfg.llama, dtype=dtype,
                flash_hole=ours(hole), flash_span=ours(span), mesh=mesh)
            _close_step(params, state, hh, done)
        state.g += 1
    return _fetch(toks, block, s_slots, cfg.stop_speech_token)


def _fetch(toks, block: int, s_slots: int, eos: int):
    """(tokens (block, S) int32 numpy, EOS past the steps run; n_steps)."""
    n = len(toks)
    out = np.full((block, s_slots), eos, np.int32)
    if n:
        with profiling.span("engine.fetch"):
            out[:n] = torch.stack(toks).cpu().numpy()
    return out, n


# ---------------------------------------------------------------------------
# the step in pieces: CUDA graphs on the card
# ---------------------------------------------------------------------------

def latent_keys(pad: torch.Tensor, g_start: torch.Tensor, dead: torch.Tensor, c: torch.Tensor,
                p_len: int, ring: int, total: int) -> torch.Tensor:
    """(2S, total) bool: the keys of `engine_spans`' spans minus their
    holes, as a mask, with the ring column c = g mod R a device value (a
    graph replays it at every step): a live slot's context [pad, p_len)
    and the ring columns from a = gs mod R to c, wrapping; a dead slot keeps
    key 0 alone (deepseek_v2.decode_valid's rule for an empty span)."""
    k = torch.arange(total, device=pad.device)[None]
    a = torch.remainder(g_start, ring)[:, None]
    r = k - p_len
    after, upto = r >= a, r <= c
    ring_on = (r >= 0) & torch.where(a > c, after | upto, after & upto)
    live = ((k >= pad[:, None]) & (k < p_len)) | ring_on
    keys = torch.where(dead[:, None], k == 0, live)
    return torch.cat([keys, keys])


class EngineStep:
    """The engine's decode step off a mesh (engine_decode_block's body) as
    pieces over static buffers of one engine, run by the capture driver
    (utils/graphs.py): called as they are off the card; on the card the
    first step is the warm-up and the capture, and later steps replay the
    graphs. Either way the work, its precision and its tokens are the
    eager step's. Where the step is cut is the backbone's `WHOLE_STEP`:

    - Llama, at K1, into n_layers + 2 pieces: the sampling (`_sample` on
      the static Gumbel rows `noise`); the opening (`_next_input`, then
      layer 0's norm, q/k/v, RoPE and ring-column write at the device index
      `col`); the piece of layer i (0 < i < L): layer i-1's o-projection
      and MLP on K1's output (copied into `att[i-1]`), then layer i's q/k/v
      and write; the last: layer L-1's o-projection and MLP, the final norm
      and `_close_step`. K1 runs between the pieces, eagerly and as
      llama.forward calls it: through `llama.decode_attention`, looked up
      at each call, at the host's cache_pos, with a span and hole made each
      step by `engine_spans`.
    - a latent backbone (`whole`), one piece: the sampling, `_next_input`,
      the backbone through its latent cache (the keys of `latent_keys`,
      the ring column written at the device index from `g`, the routed
      experts through K7) and `_close_step`. Nothing in it reads the host.
    """

    def __init__(self, params, state: EngineState, cfg: T3Config, p_len: int,
                 use_top_p: bool, dtype):
        s_slots = state.done.shape[0]
        if state.own != (0, s_slots):
            raise ValueError("the step's pieces hold every slot: a dp mesh takes the step whole")
        dev = state.logits.device
        self.params, self.state, self.cfg = params, state, cfg
        self.p_len, self.total = p_len, state.cache[0].shape[1]
        self.ring = self.total - p_len
        self.use_top_p, self.dtype = use_top_p, dtype
        self.noise = torch.zeros((s_slots, cfg.speech_tokens_dict_size), dtype=torch.float32,
                                 device=dev)
        self.whole = backbone.of(cfg.llama).WHOLE_STEP
        if self.whole:
            self.g = torch.zeros((), dtype=torch.int64, device=dev)
            pieces = [self._body]
        else:
            lc, cache = cfg.llama, state.cache
            self.layers = params["llama"]["layers"]
            self.col = torch.full((1,), p_len, dtype=torch.int64, device=dev)
            self.att = [torch.zeros((2 * s_slots, lc.num_heads, lc.head_dim), dtype=dtype,
                                    device=dev) for _ in self.layers]
            self.kv = [dict(k=cache.k[i], v=cache.v[i],
                            scales={} if cache.k_scale is None else
                            dict(k_scale=cache.k_scale[i], v_scale=cache.v_scale[i]))
                       for i in range(len(self.layers))]
            # out[0]: the sampling piece's; out[1 + i]: layer i's q and residual
            pieces = ([self._sampled, self._open]
                      + [functools.partial(self._middle, i) for i in range(1, len(self.layers))]
                      + [self._last])
        self.graphs = graphs.Graphed(pieces, dev, span="engine.capture")

    # -- a latent backbone's one piece ---------------------------------------

    def _body(self) -> dict:
        st, cfg, p = self.state, self.cfg, self.params
        tok, done = _sample(st, st.logits, self.noise, cfg, self.use_top_p)
        h, pos_id = _next_input(p, st, tok, self.p_len, self.dtype)
        c = torch.remainder(self.g, self.ring)
        keys = latent_keys(st.pad, st.g_start, done, c, self.p_len, self.ring, self.total)
        hh, _ = backbone.of(cfg.llama).forward(
            p["llama"], h, pos_id, cache=st.cache, cache_pos=(self.p_len + c).reshape(1),
            cfg=cfg.llama, dtype=self.dtype, key_valid=keys)
        _close_step(p, st, hh, done)
        return dict(tok=tok)

    # -- Llama's pieces, cut at K1 ------------------------------------------

    def _qkv_write(self, i: int, h, cos, sin):
        q, k, v = llama._qkv(self.layers[i], h, cos, sin, self.cfg.llama, self.dtype)
        llama._write_column(self.state.cache, i, self.col, k[:, 0], v[:, 0])
        return q[:, 0]

    def _close(self, i: int, h):
        """Layer i's o-projection on K1's output and its MLP."""
        lp = self.layers[i]
        h = h + L.linear(lp["o"], L.merge_heads(self.att[i][:, None]), self.dtype)
        return llama._mlp(lp, h, self.cfg.llama, self.dtype)

    def _sampled(self) -> dict:
        tok, done = _sample(self.state, self.state.logits, self.noise, self.cfg, self.use_top_p)
        return dict(tok=tok, done=done)

    def _open(self) -> dict:
        h, pos_id = _next_input(self.params, self.state, self.graphs.out[0]["tok"], self.p_len,
                                self.dtype)
        cos, sin = llama.rope_cos_sin(pos_id, self.cfg.llama)
        return dict(h=h, cos=cos, sin=sin, q=self._qkv_write(0, h, cos, sin))

    def _middle(self, i: int) -> dict:
        out = self.graphs.out
        h = self._close(i - 1, out[i]["h"])
        return dict(h=h, q=self._qkv_write(i, h, out[1]["cos"], out[1]["sin"]))

    def _last(self) -> dict:
        out, n = self.graphs.out, len(self.layers)
        h = L.rms_norm(self.params["llama"]["norm"], self._close(n - 1, out[n]["h"]),
                       self.cfg.llama.rms_norm_eps)
        _close_step(self.params, self.state, h, out[0]["done"])
        return {}

    # -- a step -------------------------------------------------------------

    def _step(self, g: int) -> torch.Tensor:
        """Step g of the pieces (noise loaded): returns its tokens (S,)."""
        run, p_len, ring = self.graphs.run, self.p_len, self.ring
        if self.whole:
            with profiling.span("engine.forward"):
                self.g.fill_(g)
                return run(0)["tok"].clone()
        with profiling.span("engine.sample"):
            sampled = run(0)
            tok = sampled["tok"].clone()
        with profiling.span("engine.forward"):
            self.col.fill_(p_len + g % ring)
            run(1)
            span, hole = engine_spans(self.state.pad, self.state.g_start, sampled["done"], g,
                                      p_len, ring)
            for i, kv in enumerate(self.kv):
                att = llama.decode_attention(self.graphs.out[1 + i]["q"], kv["k"], kv["v"],
                                             p_len + g % ring, start=0, hole=hole, span=span,
                                             **kv["scales"])
                self.att[i].copy_(att)
                run(2 + i)
        return tok

    def step(self, g: int) -> torch.Tensor:
        """Run step g (its Gumbel rows already in `noise`) and return its
        tokens (S,): on the card the first step is the warm-up, followed
        by the capture."""
        if self.graphs.captured:
            profiling.count("engine.graphed_steps")
        return self.graphs.step(functools.partial(self._step, g))


@torch.no_grad()
def pieced_decode_block(pieces: EngineStep, state: EngineState, block: int):
    """engine_decode_block through the step's pieces (EngineStep): the same
    tokens, (tokens (block, S) int32 numpy, n_steps).

    Inside a block the host draws step n+1's Gumbel rows while the card
    runs step n, before it reads step n's `done.all()`. Every source is
    called for the steps the eager loop calls it for, in the same order, so
    every draw that samples a token is the same; a block that ends on
    done.all() calls each source it held once more, at the step after, for
    a request that has finished (its source is dropped at the block's
    end). No row is drawn past the block's last step or across a refill.
    Drawn ahead, the rows' `engine.noise` spans sit beside the step's
    `engine.sample`, not inside it as in the eager step."""
    s_slots = state.done.shape[0]
    eos = pieces.cfg.stop_speech_token
    zeros = torch.zeros((pieces.noise.shape[1],), dtype=torch.float32,
                        device=pieces.noise.device)
    toks = []
    with profiling.span("engine.done_read"):
        if bool(state.done.all()):
            return _fetch(toks, block, s_slots, eos)
    _step_noise(state, state.g, zeros, pieces.noise)
    for n in range(block):
        toks.append(pieces.step(state.g))
        state.g += 1
        if n + 1 == block:
            break
        _step_noise(state, state.g, zeros, pieces.noise)
        with profiling.span("engine.done_read"):
            if bool(state.done.all()):
                break
    return _fetch(toks, block, s_slots, eos)


# ---------------------------------------------------------------------------
# host-side scheduler (token level)
# ---------------------------------------------------------------------------

@dataclass
class _Slot:
    rid: Optional[int] = None
    buf: List[np.ndarray] = field(default_factory=list)
    count: int = 0
    limit: int = 0
    pad: int = 0
    g_start: int = 0


class ContinuousDecoder:
    """Host orchestration: a request queue, S slots, block-wise decode with
    refill between blocks. Token-level API; serving/continuous.py wires it
    into the TTS pipeline.

    make_draws: the draw-source factory, called once a request with its
    seed (default `sampling.Draws(seed, device)`); on a mesh it must pickle
    (a module-level function, a class, a functools.partial).
    kv_int8: the int8 cache (None: CHATTERBOX_INT8_KV=1 asks for it);
    under a tp mesh each rank holds its heads' slabs and scales.
    mesh: the params are each rank's shard (parallel.serve.
    shard_t3_for_serving); the slots split over dp (`engine_slots`), and
    the decoder is built on every rank (module docstring).
    pieces: the step's pieces (`EngineStep`) off a mesh, captured as CUDA
    graphs in the first block on the card; None on a mesh, where the step
    runs whole.
    route_record: a latent backbone's engine keeps every row's expert ids
    (`LatentCache.route`), and each finished request's are copied to the
    host into `routes` {rid: (moe layers, positions, 2, k) int16}, over its
    context columns [pad, p_len) and its first n - 1 steps (the tokens fed
    back): the caller takes them from there.
    """

    def __init__(self, params, cfg: T3Config = T3Config(), *, slots: int = 8,
                 text_bucket: int = 192, max_new_tokens: int = 512, block: int = 64,
                 dtype=torch.float32, kv_int8: Optional[bool] = None,
                 use_top_p: bool = False, retain_results: bool = True,
                 make_draws: Optional[Callable[[int], object]] = None, device=None,
                 mesh=None, route_record: bool = False):
        self.kv_int8 = llama._kv_int8_mode() > 0 if kv_int8 is None else bool(kv_int8)
        bb = backbone.of(cfg.llama)
        backbone.check(cfg.llama, int8_cache=self.kv_int8, mesh=mesh is not None)
        self.route_record = route_record
        self.routes: Dict[int, np.ndarray] = {}
        own = engine_slots(mesh, slots)
        self.mesh = mesh
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.text_bucket = text_bucket
        self.max_new_cap = max_new_tokens
        self.block = block
        self.dtype = dtype
        self.use_top_p = use_top_p
        self.make_draws = make_draws or functools.partial(sampling.Draws, device=self.device)
        self.cond_w = 2 + cfg.perceiver_num_queries
        self.p_len, self.total = engine_geometry(cfg, text_bucket, self.cond_w, max_new_tokens)
        self.state = engine_init(cfg, slots=slots, text_bucket=text_bucket, cond_w=self.cond_w,
                                 max_new_tokens=max_new_tokens, dtype=dtype, device=self.device,
                                 own=own, heads=bb.kv_heads(params["llama"], cfg.llama),
                                 kv_int8=self.kv_int8, route_record=route_record)
        # the step's pieces off a mesh (graphed on the card); None: the step
        # whole, on a mesh, whose collectives a graph cannot hold
        self.pieces = (None if mesh is not None else
                       EngineStep(params, self.state, cfg, self.p_len, use_top_p, dtype))
        self._queue: List[dict] = []
        self._slots = [_Slot() for _ in range(slots)]
        # retain_results=False for run-forever callers that consume step()'s
        # return value (drain() callers keep True)
        self.retain_results = retain_results
        self._results: Dict[int, np.ndarray] = {}
        self._next_rid = 0
        # {rid: this block's new ids} for every request that advanced in the
        # LAST step(), finished ones trimmed at EOS / limit (streaming reads it)
        self.last_block_tokens: Dict[int, np.ndarray] = {}
        self.blocks_run = 0
        self.steps_run = 0
        # host seconds of the decode blocks and their fetches
        self.t_decode = 0.0
        if mesh is not None and mesh.leads():
            mesh.adopt(self, ContinuousDecoder, params, cfg, slots=slots,
                       text_bucket=text_bucket, max_new_tokens=max_new_tokens, block=block,
                       dtype=dtype, kv_int8=self.kv_int8, use_top_p=use_top_p,
                       retain_results=retain_results,
                       make_draws=make_draws, device=device, mesh=mesh)

    # -- submission ---------------------------------------------------------

    @on_mesh_method
    def submit(self, text_tokens: np.ndarray, cond: t3.T3Cond, *, temperature: float = 0.8,
               cfg_weight: float = 0.5, repetition_penalty: float = 1.2,
               min_p: float = 0.05, top_p: float = 1.0, seed: int = 0,
               max_new_tokens: Optional[int] = None) -> int:
        """Queue one utterance. Returns a request id; the decoded ids (EOS
        included, like t3.generate) appear in step()'s completions. Refuses
        a cond without prompt tokens, text over the bucket and top_p < 1
        without use_top_p."""
        if t3.cond_width(cond, self.cfg) != self.cond_w:
            raise ValueError("engine slots are laid out for prompt-token conds "
                             f"(cond width {self.cond_w}); got width "
                             f"{t3.cond_width(cond, self.cfg)}")
        n_text = np.atleast_2d(np.asarray(text_tokens)).shape[1]
        if n_text > self.text_bucket:
            raise ValueError(f"text ({n_text} tokens) exceeds the engine's text bucket "
                             f"({self.text_bucket}); chunk the text or build a wider engine")
        if top_p < 1.0 and not self.use_top_p:
            raise ValueError("top_p < 1.0 requires use_top_p=True at engine construction")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(dict(
            rid=rid, text=np.atleast_2d(np.asarray(text_tokens, np.int32)), cond=cond,
            temperature=float(temperature), cfg_weight=float(cfg_weight),
            rep_penalty=float(repetition_penalty), min_p=float(min_p), top_p=float(top_p),
            seed=int(seed),
            max_new=min(int(max_new_tokens or self.max_new_cap), self.max_new_cap)))
        return rid

    # -- engine loop --------------------------------------------------------

    def _refill(self):
        with profiling.span("engine.refill"):
            for s_idx, sl in enumerate(self._slots):
                if sl.rid is not None or not self._queue:
                    continue
                req = self._queue.pop(0)
                with profiling.span("engine.prefill", rid=req["rid"]):
                    pad = self.text_bucket - req["text"].shape[1]
                    sub = None
                    if self.state.own[0] <= s_idx < self.state.own[1]:
                        sub, pad = prefill_request(
                            self.params, req["cond"], req["text"], text_bucket=self.text_bucket,
                            p_len=self.p_len, cfg=self.cfg, dtype=self.dtype,
                            device=self.device, mesh=self.mesh, kv_int8=self.kv_int8,
                            route_record=self.route_record)
                    meta = dict(limit=req["max_new"], pad=pad, **{
                        k: req[k] for k in ("temperature", "cfg_weight", "rep_penalty", "min_p",
                                            "top_p")})
                    engine_insert(self.state, sub, s_idx, self.make_draws(req["seed"]), meta)
                    self._slots[s_idx] = _Slot(rid=req["rid"], limit=req["max_new"], pad=pad,
                                               g_start=self.state.g)

    @property
    def idle(self) -> bool:
        return not self._queue and all(s.rid is None for s in self._slots)

    @on_mesh_method
    def step(self) -> Dict[int, np.ndarray]:
        """Refill free slots, decode one block, return {rid: ids} finished
        this block. An idle engine returns {} and clears last_block_tokens
        (the JAX package's step keeps the previous block's there, ROADMAP
        §3)."""
        with profiling.span("engine.step"):
            self._refill()
            if all(s.rid is None for s in self._slots):
                self.last_block_tokens = {}
                return {}
            t0 = time.perf_counter()
            with profiling.span("engine.block"):
                if self.pieces is not None:
                    tokens_h, nj = pieced_decode_block(self.pieces, self.state, self.block)
                else:
                    tokens_h, nj = engine_decode_block(self.params, self.state, self.cfg,
                                                       self.block, self.p_len, self.use_top_p,
                                                       self.dtype, self.mesh)
                with profiling.span("engine.fetch"):
                    done_h = self.state.done.cpu().numpy()
            self.t_decode += time.perf_counter() - t0
            self.blocks_run += 1
            self.steps_run += nj
            eos = self.cfg.stop_speech_token
            out: Dict[int, np.ndarray] = {}
            self.last_block_tokens = {}
            for s_idx, sl in enumerate(self._slots):
                if sl.rid is None:
                    continue
                prev = sl.count
                sl.buf.append(tokens_h[:nj, s_idx])
                sl.count += nj
                if bool(done_h[s_idx]):
                    seq = np.concatenate(sl.buf)
                    eos_pos = np.nonzero(seq == eos)[0]
                    end = int(eos_pos[0]) + 1 if eos_pos.size else seq.shape[0]
                    # a limit-terminated row emits fill-EOS once done: clamp at the
                    # limit (a genuine EOS always lies within it)
                    end = min(end, sl.limit)
                    out[sl.rid] = seq[:end]
                    self.last_block_tokens[sl.rid] = seq[prev:end]
                    if self.route_record:
                        self.routes[sl.rid] = self._routes_of(s_idx, sl, end)
                    if self.retain_results:
                        self._results[sl.rid] = out[sl.rid]
                    self._slots[s_idx] = _Slot()
                    self.state.draws[s_idx] = None
                else:
                    self.last_block_tokens[sl.rid] = tokens_h[:nj, s_idx]
            return out

    def _routes_of(self, s_idx: int, sl: _Slot, n: int) -> np.ndarray:
        """A finished request's expert ids, (moe layers, positions, 2, k):
        its context columns, then the ring columns of its first n - 1
        steps, of its cond and uncond rows (read before the slot refills)."""
        rec = self.state.cache.route
        ring = self.total - self.p_len
        cols = (list(range(sl.pad, self.p_len))
                + [self.p_len + (sl.g_start + t) % ring for t in range(n - 1)])
        idx = torch.tensor(cols, dtype=torch.int64, device=rec.device)
        rows = torch.tensor([s_idx, self.slots + s_idx], dtype=torch.int64, device=rec.device)
        return rec.index_select(1, idx).index_select(2, rows).cpu().numpy()

    @on_mesh_method
    def drain(self) -> Dict[int, np.ndarray]:
        """Run until every queued and live request completes; returns all
        results retained so far (earlier step() completions included)."""
        while not self.idle:
            self.step()
        return dict(self._results)
