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
from ..utils import profiling
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
    cache: llama.KVCache          # (L, total, 2S', H, D) sequence-major, S' = s1 - s0
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
                kv_int8: bool = False) -> EngineState:
    """All-free engine state on `device` (None: the card): every slot done,
    with pad = p_len. The cache has the compute dtype, or is int8 with its
    scale planes (`kv_int8`). own: the slots [s0, s1) whose rows this rank
    holds (default all); heads: its K/V heads (default all,
    llama.init_cache)."""
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
        cache=llama.init_cache(cfg.llama, 2 * mine, total, torch.int8 if kv_int8 else dtype,
                               device, heads=heads),
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
                    kv_int8: bool = False):
    """Prefill ONE request's 2 CFG rows into a p_len-capacity DecodeState
    (t3._build_context and t3.prefill, left-padded to the engine's text
    bucket; `mesh`: the tp ranks of the params' shards; `kv_int8`: an int8
    cache). Returns (state, pad)."""
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
                      kv_int8=kv_int8), pad


@torch.no_grad()
def engine_insert(state: EngineState, sub: t3.DecodeState, slot: int, draws,
                  meta: Dict[str, float]) -> None:
    """Put a prefilled request (prefill_request's state, capacity p_len)
    into slot `slot`, in place: its cache columns [0, p_len) of the slot's
    cond and uncond rows (and of an int8 cache's scale planes), their
    logits, its counts and sampling parameters,
    and its join step g. meta: limit, pad, temperature, cfg_weight,
    repetition_penalty, min_p, top_p. Every write takes a host scalar or a
    device tensor; no copy waits for the device. A rank that does not hold
    the slot's rows passes sub None and keeps only the bookkeeping."""
    s0, s1 = state.own
    if sub is not None:
        p_len = sub.cache.k.shape[1]
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
    logits are gathered over dp before each step's sampling."""
    s_slots = state.done.shape[0]
    s0, s1 = state.own
    local = None                                      # this rank's rows of the 2S
    if (s0, s1) != (0, s_slots):
        mine = torch.arange(s0, s1, device=state.logits.device)
        local = torch.cat([mine, s_slots + mine])

    def ours(x):
        return x if local is None else x[local].contiguous()

    dev = state.logits.device
    eos = cfg.stop_speech_token
    v = cfg.speech_tokens_dict_size
    total = state.cache.k.shape[1]
    ring = total - p_len
    rows = torch.arange(s_slots, device=dev)
    pos_emb = params["speech_pos_emb"]["w"]
    zeros = torch.zeros((v,), dtype=torch.float32, device=dev)
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
            lc, lu = logits[:s_slots], logits[s_slots:]
            lg = sampling.process_logits(
                lc + state.cfg_weight * (lc - lu), state.counts,
                valid_size=cfg.start_speech_token, eos_id=eos, temperature=state.temperature,
                repetition_penalty_val=state.rep_penalty, min_p=state.min_p, top_p=state.top_p,
                use_top_p=use_top_p)
            with profiling.span("engine.noise"):
                noise = torch.stack([
                    zeros if d is None else d.gumbel(state.g - gs, (v,)).to(dev)
                    for d, gs in zip(state.draws, state.g_start_host)])
            tok = sampling.sample_token(lg, noise)
            tok = torch.where(state.done, torch.full_like(tok, eos), tok)
            toks.append(tok)
            state.counts[rows, tok] += 1
            done = state.done | (tok == eos) | (state.i + 1 >= state.limit)
        with profiling.span("engine.forward"):
            emb = L.embedding(params["speech_emb"], tok) + pos_emb[state.i + 1]
            emb = ours(torch.cat([emb, emb]))[:, None]
            pos_id = (p_len - state.pad + state.i)[:, None]
            span, hole = engine_spans(state.pad, state.g_start, done, state.g, p_len, ring)
            hh, _ = llama.forward(params["llama"], emb.to(dtype),
                                  ours(torch.cat([pos_id, pos_id])), cache=state.cache,
                                  cache_pos=p_len + state.g % ring, cfg=cfg.llama, dtype=dtype,
                                  flash_hole=ours(hole), flash_span=ours(span), mesh=mesh)
            state.logits = L.linear(params["speech_head"], hh[:, -1], torch.float32)
        state.i = torch.where(state.done, state.i, state.i + 1)
        state.done = done
        state.g += 1
    n = len(toks)
    out = np.full((block, s_slots), eos, np.int32)
    if n:
        with profiling.span("engine.fetch"):
            out[:n] = torch.stack(toks).cpu().numpy()
    return out, n


# ---------------------------------------------------------------------------
# host-side scheduler (token level)
# ---------------------------------------------------------------------------

@dataclass
class _Slot:
    rid: Optional[int] = None
    buf: List[np.ndarray] = field(default_factory=list)
    count: int = 0
    limit: int = 0


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
    """

    def __init__(self, params, cfg: T3Config = T3Config(), *, slots: int = 8,
                 text_bucket: int = 192, max_new_tokens: int = 512, block: int = 64,
                 dtype=torch.float32, kv_int8: Optional[bool] = None,
                 use_top_p: bool = False, retain_results: bool = True,
                 make_draws: Optional[Callable[[int], object]] = None, device=None,
                 mesh=None):
        self.kv_int8 = llama._kv_int8_mode() > 0 if kv_int8 is None else bool(kv_int8)
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
                                 own=own, heads=llama.kv_heads(params["llama"], cfg.llama),
                                 kv_int8=self.kv_int8)
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
                            device=self.device, mesh=self.mesh, kv_int8=self.kv_int8)
                    meta = dict(limit=req["max_new"], pad=pad, **{
                        k: req[k] for k in ("temperature", "cfg_weight", "rep_penalty", "min_p",
                                            "top_p")})
                    engine_insert(self.state, sub, s_idx, self.make_draws(req["seed"]), meta)
                    self._slots[s_idx] = _Slot(rid=req["rid"], limit=req["max_new"])

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
                    if self.retain_results:
                        self._results[sl.rid] = out[sl.rid]
                    self._slots[s_idx] = _Slot()
                    self.state.draws[s_idx] = None
                else:
                    self.last_block_tokens[sl.rid] = tokens_h[:nj, s_idx]
            return out

    @on_mesh_method
    def drain(self) -> Dict[int, np.ndarray]:
        """Run until every queued and live request completes; returns all
        results retained so far (earlier step() completions included)."""
        while not self.idle:
            self.step()
        return dict(self._results)
