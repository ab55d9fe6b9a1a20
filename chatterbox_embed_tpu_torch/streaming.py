"""Streaming synthesis, the PyTorch counterpart of
`chatterbox_embed_tpu/streaming.py`: the stream's first chunk as one
program (`first_chunk`), the decode resumed from it (`continue_tokens`) and
the windowed flow + vocoder tail over the later token blocks
(`WindowedSynth`).

The first chunk is the text's context, the prefill, the first decode block
of `block_tokens` steps, the first flow window and the first vocoder window
(the JAX package's `_first_chunk_impl`, one jitted program a text bucket).
Here it is one static-shape body (`_first_chunk_body`): every step runs
whatever the tokens turn out to be, and the text's left pad, the token
limit, the sampling values, the decode's done flags and counts stay on the
device. On the card the body is captured once as a CUDA graph per (model,
text bucket, block, cache capacity, dtype, decode step, top-p; the voice's
prompt shapes and CHATTERBOX_DEFER_KV, which the captured kernels bake in)
and replayed for every later request of that key: one launch from the host
where the eager body makes several thousand. The graphs are kept in
`GRAPHS`, the least recently used dropped past GRAPHS_KEPT, and a model's
go with it (`GRAPHS.release`). A caller that asks for the CPU runs the same
body eagerly. The replay's outputs are copied out of the graph's memory
before they are returned, so streams of one key may interleave. A capture
or a replay that fails raises; nothing falls back to the eager body on the
card.

Draws: one draw source serves a stream. T3 step i takes draws.gumbel(i);
the vocoder windows take draws.stream_phase (one per utterance) and
draws.window_noise(k) for window k (ops/sampling.py:Draws). A graph's
draws are made before its replay, in the order the eager body takes them
(the block's Gumbel noise by step, then the phases and window 0's noise),
into its input buffers.
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .config import SPEECH_VOCAB_SIZE, ChatterboxConfig
from .device import resolve_device
from .kernels import flash_attention, flash_decode, fused_decode, rel_attention
from .models import hifigan as hift_mod
from .models import llama as llama_mod
from .models import s3gen as s3gen_mod
from .models import t3 as t3_mod
from .ops import sampling

# Windowed-streaming geometry (the flow's context tokens and the vocoder's
# context mel frames); read once at import, as in the JAX package.
STREAM_CTX_TOKENS = int(os.getenv("CHATTERBOX_STREAM_CTX", "6"))      # C (> pre-lookahead 3)
STREAM_VOC_CTX_MEL = int(os.getenv("CHATTERBOX_STREAM_VOC_CTX", "8"))  # M (covers conv fields)


class FirstChunk(NamedTuple):
    """The first-chunk program's outputs, on the device."""
    state: t3_mod.DecodeState     # resumable decode state (i a device count)
    tokens: torch.Tensor          # (block, 1) int32 generated ids, zero past n_new
    n_new: torch.Tensor           # () int32 tokens actually generated
    wav: torch.Tensor             # (1, r*(block+look)*480) fp32 padded waveform
    n_valid_mel: torch.Tensor     # () valid mel frames in `wav`
    mu_tail: torch.Tensor         # (1, PIN, 80) flow continuity tail
    mel_tail: torch.Tensor        # (1, M, 80) vocoder context tail
    phase_carry: torch.Tensor     # (1, nh+1) harmonic phase carry


class _Inputs(NamedTuple):
    """What varies between the requests of one first-chunk program: its
    graph's input buffers on the card."""
    text_tokens: torch.Tensor     # (1, bucket) int64, left-padded
    pad: torch.Tensor             # () int32: the left pad
    limit: torch.Tensor           # () int32: max_new_tokens
    sampling: torch.Tensor        # (5,) fp32: temperature, cfg_weight,
                                  # repetition_penalty, min_p, top_p
    speaker_emb: torch.Tensor     # (1, 256) fp32
    cond_prompt: Optional[torch.Tensor]   # (1, Lp) int32 or None
    emotion: torch.Tensor         # (1,) fp32
    prompt_tokens: torch.Tensor   # (1, P) int64
    prompt_feat: torch.Tensor     # (1, 2P, 80) fp32
    embedding: torch.Tensor       # (1, 192) fp32


class _Static(NamedTuple):
    """What a first-chunk program is built for (its graph's key, less the
    model and the input shapes)."""
    block: int
    total: int
    p_len: int
    use_fused: bool
    use_top_p: bool
    voc_ctx: int
    dtype: torch.dtype


@torch.no_grad()
def _first_chunk_body(t3_params, s3_params, inp: _Inputs, draws, st: _Static, fused,
                      cfg: ChatterboxConfig) -> FirstChunk:
    """Context, prefill, the first decode block, the first flow window and
    the first vocoder window (the JAX package's _first_chunk_impl), with no
    step that waits on the host."""
    t3c, s3c = cfg.t3, cfg.s3gen
    r = s3c.flow.token_mel_ratio
    look = s3c.flow.pre_lookahead_len
    block, dev = st.block, inp.text_tokens.device

    # T3: t3.start_generation's context and prefill for one utterance under
    # CFG (the cache in the compute dtype whatever CHATTERBOX_INT8_KV says,
    # as the JAX package's first chunk prefills), then the first block
    cond = t3_mod.T3Cond(inp.speaker_emb, inp.cond_prompt, inp.emotion)
    context = t3_mod._build_context(t3_params, cond, inp.text_tokens, t3c, True, inp.pad)
    state = t3_mod.prefill(t3_params, context, t3c, st.total, inp.pad, True, st.dtype)
    ginfo = dict(p_len=st.p_len, pad=inp.pad, cfg_on=True, hole=None, use_fused=st.use_fused,
                 fused=fused, align_layer=None, mesh=None)
    sp = sampling.SamplingParams(*inp.sampling.unbind(0))
    state, tokens, n_new = t3_mod.decode_fixed_block(
        t3_params, state, ginfo, sp, draws, block=block, limit=inp.limit,
        use_top_p=st.use_top_p, cfg=t3c, dtype=st.dtype)

    # the first flow window (no context, absolute frame 0): the valid tokens
    # exclude EOS and any id >= the flow vocabulary, which become the pad id
    win = tokens.T.long()                                       # (1, block)
    valid = (torch.arange(block, device=dev) < n_new) & (win[0] < s3c.flow.vocab_size)
    n_valid_tok = valid.sum()
    win = torch.where(win >= s3c.flow.vocab_size, torch.zeros_like(win), win)
    vlen = n_valid_tok.clamp_min(1).reshape(1)
    pin = r * (STREAM_CTX_TOKENS - look)
    mu_pin0 = torch.zeros((1, pin, s3c.mel_num), device=dev)
    mel_gen, mu_tail = s3gen_mod.flow_to_mel_window(
        s3_params, win, vlen, inp.prompt_tokens, inp.prompt_feat, inp.embedding, mu_pin0,
        pin_frames=0, noise_off=0, finalize=False, cfg=s3c, dtype=st.dtype)

    # the vocoder window over the emittable frames, zero-padded to
    # r * (block + look) frames: WindowedSynth's first window exactly
    n_valid = r * (n_valid_tok - look).clamp_min(0)
    new_cap = r * (block + look)
    frame = torch.arange(r * block, device=dev)
    mel_emit = mel_gen[:, : r * block] * (frame[None, :, None] < n_valid)
    mel_win = F.pad(mel_emit, (0, 0, 0, new_cap - r * block))
    up = s3c.hift.total_upsample
    carry_idx = ((n_valid - n_valid.clamp(max=st.voc_ctx)) * up - 1).clamp_min(0)
    phase0 = torch.zeros((1, s3c.hift.nb_harmonics + 1), device=dev)
    wav, carry = hift_mod.stream_synthesize(s3_params["hift"], mel_win, draws, 0, phase0,
                                            carry_idx, cfg=s3c.hift, dtype=st.dtype)
    fade = s3gen_mod.trim_fade_on(dev)
    wav = wav.float()
    wav[:, : fade.shape[0]] *= fade
    # the vocoder context: the last voc_ctx valid frames, the start clamped
    # into the window as JAX's dynamic_slice clamps it
    tail0 = (n_valid - st.voc_ctx).clamp(0, new_cap - st.voc_ctx)
    mel_tail = mel_win.index_select(1, tail0 + torch.arange(st.voc_ctx, device=dev))
    return FirstChunk(state, tokens, n_new, wav, n_valid, mu_tail, mel_tail, carry)


# ---------------------------------------------------------------------------
# the first chunk as a CUDA graph
# ---------------------------------------------------------------------------

def _counters():
    """(wrapper, attribute) of every kernel launch counter the body can
    move (K1 / K1s and their int8 entries, K4, K2, K3)."""
    fd = flash_decode.decode_attention
    return ([(fd, a) for a in ("launches", "launches_deferred", "launches_int8",
                               "launches_int8_deferred")]
            + [(fused_decode.fused_decode_step, "launches"),
               (rel_attention.rel_attention, "launches"),
               (flash_attention.flash_attention, "launches")])


class _BufferedDraws:
    """A graph's draws: input buffers that `fill` loads from a draw source
    before each replay, in the order the eager body draws."""

    def __init__(self, block: int, vocab: int, nh: int, samples: int, device):
        self.gumbels = torch.zeros((block, 1, vocab), device=device)
        self.phase = torch.zeros((1, nh, 1), device=device)
        self.noise = torch.zeros((1, nh, samples), device=device)

    def fill(self, draws) -> None:
        for j in range(self.gumbels.shape[0]):
            self.gumbels[j].copy_(draws.gumbel(j, tuple(self.gumbels.shape[1:])))
        self.phase.copy_(draws.stream_phase(tuple(self.phase.shape)))
        self.noise.copy_(draws.window_noise(0, tuple(self.noise.shape)))

    def gumbel(self, step: int, shape):
        return self.gumbels[step]

    def stream_phase(self, shape):
        return self.phase

    def window_noise(self, window: int, shape):
        if window != 0:
            raise ValueError("the first chunk draws window 0's noise only")
        return self.noise


class FirstChunkGraph:
    """One captured first-chunk program: its input buffers and draws, the
    graph, its outputs (in the graph's memory), the kernel launches it holds
    ({counter: launches a replay}), the bytes its capture reserved and its
    replays so far."""

    def __init__(self, inputs: _Inputs, draws: _BufferedDraws, keep):
        self.inputs, self.draws, self.keep = inputs, draws, keep
        self.graph = torch.cuda.CUDAGraph()
        self.out: Optional[FirstChunk] = None
        self.launches: dict = {}
        self.pool_bytes = 0
        self.replays = 0
        self.workspaces: dict = {}

    def replay(self) -> None:
        self.graph.replay()
        for (fn, attr), n in self.launches.items():
            setattr(fn, attr, getattr(fn, attr) + n)
        self.replays += 1


class _GraphCache(OrderedDict):
    """The captured first-chunk graphs by key, least recently used first.
    An entry holds its graph's memory pool (~220 MB at T3's width, bf16)
    and keeps its model's weights alive, so at most `kept` stay (as the
    fused step's weight walls, models/t3.py), and `release` drops a
    model's entries (a key names its models by identity)."""

    def __init__(self, kept: int):
        super().__init__()
        self.kept = kept

    def lookup(self, key):
        entry = self.get(key)
        if entry is not None:
            self.move_to_end(key)
        return entry

    def keep(self, key, entry) -> None:
        self[key] = entry
        while len(self) > self.kept:
            self.popitem(last=False)

    def release(self, *models) -> None:
        """Drop the graphs captured with any of `models` (param trees, as
        first_chunk took them: T3's "llama" or S3Gen's "flow")."""
        ids = {id(m) for m in models}
        for key in [k for k in self if ids & set(k[1])]:
            del self[key]


# (device, (T3's and the flow's params by identity), bucket, _Static,
# CHATTERBOX_DEFER_KV, config, input shapes) -> FirstChunkGraph
GRAPHS_KEPT = 4
GRAPHS = _GraphCache(GRAPHS_KEPT)


_CAPTURE_STREAMS: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    s = _CAPTURE_STREAMS.get(str(device))
    if s is None:
        s = _CAPTURE_STREAMS[str(device)] = torch.cuda.Stream(device)
    return s


def _copy_out(fc: FirstChunk) -> FirstChunk:
    """The outputs cloned out of the graph's memory, which the next replay
    of the same graph overwrites (continue_tokens writes the cache in
    place)."""
    s = fc.state
    cache = llama_mod.KVCache(*(None if x is None else x.clone() for x in s.cache))
    state = s._replace(cache=cache, logits=s.logits.clone(), counts=s.counts.clone(),
                       i=s.i.clone(), done=s.done.clone())
    return FirstChunk(state, *(x.clone() for x in fc[1:]))


def _graph_first_chunk(key, t3_params, s3_params, inp: _Inputs, draws, st: _Static, fused,
                       cfg: ChatterboxConfig):
    """The body through its graph: the first request of a key warms the
    body up on the capture stream (its result is this request's), captures
    it and keeps the graph; a later one loads the inputs and draws into the
    graph's buffers and replays it. Returns (FirstChunk, "captured" or
    "replayed")."""
    entry = GRAPHS.lookup(key)
    if entry is not None:
        for buf, x in zip(entry.inputs, inp):
            if buf is not None:
                buf.copy_(x)
        entry.draws.fill(draws)
        entry.replay()
        return _copy_out(entry.out), "replayed"

    dev = inp.text_tokens.device
    s3c = cfg.s3gen
    r, look = s3c.flow.token_mel_ratio, s3c.flow.pre_lookahead_len
    bufs = _BufferedDraws(st.block, cfg.t3.speech_tokens_dict_size, s3c.hift.nb_harmonics + 1,
                          r * (st.block + look) * s3c.hift.total_upsample, dev)
    bufs.fill(draws)
    static = _Inputs(*(None if x is None else x.clone() for x in inp))
    entry = FirstChunkGraph(static, bufs, (t3_params, s3_params, fused))
    side = _capture_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        # the warm-up, eager on the capture stream: builds the kernels, the
        # library plans and the device constants before the capture, and
        # gives this request's first chunk
        first = _first_chunk_body(t3_params, s3_params, static, bufs, st, fused, cfg)
    torch.cuda.current_stream(dev).wait_stream(side)
    counters = _counters()
    before = [getattr(fn, attr) for fn, attr in counters]
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(dev)
    with flash_decode.graph_workspaces() as own, torch.cuda.graph(entry.graph, stream=side):
        entry.out = _first_chunk_body(t3_params, s3_params, static, bufs, st, fused, cfg)
    entry.workspaces = own
    entry.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
    # a capture records launches without running them: what it counted is
    # what every replay runs
    for (fn, attr), n0 in zip(counters, before):
        if getattr(fn, attr) != n0:
            entry.launches[(fn, attr)] = getattr(fn, attr) - n0
            setattr(fn, attr, n0)
    GRAPHS.keep(key, entry)
    return first, "captured"


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def first_chunk(t3_params, s3_params, cond: t3_mod.T3Cond, text_tokens: np.ndarray, *,
                prompt_tokens, prompt_feat, embedding, block_tokens: int = 25,
                max_new_tokens: int = 1000, temperature: float = 0.6, cfg_weight: float = 0.3,
                repetition_penalty: float = 1.2, min_p: float = 0.05, top_p: float = 1.0,
                seed: int = 0, voc_ctx: int = STREAM_VOC_CTX_MEL,
                cfg: ChatterboxConfig = ChatterboxConfig(), dtype=torch.float32, draws=None,
                device=None) -> tuple:
    """Synthesise the first `block_tokens` of speech in one program (the
    JAX package's first_chunk): on the card one CUDA graph replay (the
    first request of a key captures it), on the CPU the same body eagerly.

    text_tokens (1, T) wrapped in SOT/EOT; prompt_tokens / prompt_feat /
    embedding the voice's S3Gen prompt on `device`. The sampling values are
    scalars, and on the card the graph's inputs: another value replays the
    same graph (top-p below 1.0 or not is another graph). draws: the
    stream's draw source (`Draws(seed, device)` by default), which
    continue_tokens and the WindowedSynth go on drawing from. Returns
    (FirstChunk, resume): `wav[0, : n_valid_mel * 480]` is the emittable
    audio (`host_fields` copies it to the host), and `resume`
    carries what continue_tokens needs, the decode forwards run so far
    (`decode_steps`, which continue_tokens keeps up to date) and the route
    the chunk took ("captured", "replayed" or "eager" off the card). CFG
    only (cfg_weight > 0, the deployed configuration)."""
    if not float(np.asarray(cfg_weight, np.float32)) > 0.0:
        raise ValueError("first_chunk: the first-chunk program takes cfg_weight > 0")
    device = resolve_device(device)
    t3c = cfg.t3
    tt_np = np.atleast_2d(np.asarray(text_tokens, np.int32))
    lt = tt_np.shape[1]
    if tt_np.shape[0] != 1 or lt > t3c.max_text_seq_len:
        raise ValueError(f"first_chunk: one utterance of at most {t3c.max_text_seq_len} text "
                         f"tokens, got {tt_np.shape}")
    if max(max_new_tokens, block_tokens) >= t3c.max_speech_seq_len:
        raise ValueError(f"max_new_tokens={max_new_tokens} / block {block_tokens} needs more "
                         f"than the {t3c.max_speech_seq_len} speech positions")
    bucket = min(t3_mod._bucket(lt), t3c.max_text_seq_len)
    # the per-block route's capacity (t3.start_generation), where the JAX
    # program takes p_len + max(max_new_tokens, block): K1's split count
    # follows the capacity, so the two routes sum their attention in one
    # order only at one capacity
    pad, p_len, cap = t3_mod._capacity(lt, cond, t3c, True, max_new_tokens)
    cap = max(cap, p_len + block_tokens)
    total = -(-cap // t3_mod.CACHE_ALIGN) * t3_mod.CACHE_ALIGN
    use_fused = t3_mod._fused_gate(t3_params, t3c, 1, True, False, None)
    fused = t3_mod._fused_params(t3_params, t3c, dtype) if use_fused else None
    sp = sampling.SamplingParams(*(float(np.asarray(v, np.float32)) for v in (
        temperature, cfg_weight, repetition_penalty, min_p, top_p)))
    use_top_p = sp.top_p < 1.0
    st = _Static(block_tokens, total, p_len, use_fused, use_top_p, int(voc_ctx), dtype)
    draws = draws if draws is not None else sampling.Draws(seed, device)

    emo = torch.as_tensor(cond.emotion_adv, dtype=torch.float32).reshape(-1)[:1]
    prompt = cond.cond_prompt_speech_tokens
    inp = _Inputs(
        torch.from_numpy(np.pad(tt_np, ((0, 0), (pad, 0))).astype(np.int64)).to(device),
        torch.tensor(pad, dtype=torch.int32).to(device),
        torch.tensor(max_new_tokens, dtype=torch.int32).to(device),
        torch.tensor(sp, dtype=torch.float32).to(device),
        cond.speaker_emb.reshape(1, -1).float().to(device),
        None if prompt is None else prompt.to(device=device, dtype=torch.int32),
        emo.to(device), prompt_tokens.to(device=device, dtype=torch.int64),
        prompt_feat.to(device=device, dtype=torch.float32),
        embedding.to(device=device, dtype=torch.float32))
    route = "eager"
    if device.type == "cuda":
        key = (str(device), (id(t3_params["llama"]), id(s3_params["flow"])), bucket, st,
               llama_mod._defer_kv_enabled(), cfg,
               tuple(None if x is None else tuple(x.shape) for x in inp))
        fc, route = _graph_first_chunk(key, t3_params, s3_params, inp, draws, st, fused, cfg)
    else:
        fc = _first_chunk_body(t3_params, s3_params, inp, draws, st, fused, cfg)
    ginfo = dict(p_len=p_len, pad=pad, cfg_on=True, cache_total=total, hole=None,
                 use_fused=use_fused, kv_int8=False, phase_totals=[total], fused=fused,
                 align_layer=None, text_start=None, text_len=None, mesh=None, rows=(0, 2))
    resume = dict(draws=draws, sp=sp, use_top_p=use_top_p, ginfo=ginfo, block=block_tokens,
                  max_new_tokens=max_new_tokens, decode_steps=block_tokens, route=route)
    t3_mod.LAST_GENERATION_INFO.clear()
    t3_mod.LAST_GENERATION_INFO.update(
        p_len=p_len, cache_total=total, n_utt=1, alignment=False, use_fused=use_fused,
        kv_int8=False, phase_totals=[total], mesh=None, fused_first_chunk=True,
        first_chunk_graph=route)
    return fc, resume


def host_fields(fc: FirstChunk):
    """(tokens (block,) int32, n_new, n_valid_mel, wav (samples,) fp32,
    mel_tail (1, M, 80) fp32) in host memory from ONE device-to-host copy
    (the JAX package's single device_get); token ids and counts are exact
    in fp32."""
    parts = (fc.tokens.reshape(-1), fc.n_new.reshape(1), fc.n_valid_mel.reshape(1),
             fc.wav.reshape(-1), fc.mel_tail.reshape(-1))
    flat = torch.cat([p.float() for p in parts]).cpu().numpy()
    nb, nw = fc.tokens.numel(), fc.wav.numel()
    return (flat[:nb].astype(np.int32), int(flat[nb]), int(flat[nb + 1]),
            flat[nb + 2: nb + 2 + nw], flat[nb + 2 + nw:].reshape(fc.mel_tail.shape))


def continue_tokens(t3_params, fc: FirstChunk, resume: dict, *,
                    cfg: ChatterboxConfig = ChatterboxConfig(), dtype=torch.float32):
    """Yield further speech-token blocks (n,) int32 from a FirstChunk's
    state (the JAX package's continue_tokens): t3.decode_block from the
    first chunk's step on, `block` steps a call, drawing from the stream's
    draw source. The caller drops EOS, as generate_stream's consumers do."""
    state = fc.state
    produced = int(fc.n_new)
    if bool(state.done.all()):
        return
    state = state._replace(i=produced)
    while produced < resume["max_new_tokens"]:
        state, tokens, n = t3_mod.decode_block(
            t3_params, state, resume["ginfo"], resume["sp"], resume["draws"],
            block=resume["block"], limit=resume["max_new_tokens"],
            use_top_p=resume["use_top_p"], stop_on_eos=True, cfg=cfg.t3, dtype=dtype)
        resume["decode_steps"] = state.forwards
        if n > 0:
            yield tokens[:n, 0]
        produced += n
        if n == 0 or bool(state.done.all()):
            break


class WindowedSynth:
    """Incremental flow + vocoder tail over a stream of speech-token blocks
    (the JAX package's streaming.WindowedSynth):
    - the flow runs on [prompt; last C tokens; new tokens] with mu pinned
      over already-emitted frames and the CFM noise at absolute frame
      positions (s3gen.flow_to_mel_window);
    - the vocoder synthesises [M context mel frames; new frames] with a
      phase-continuous harmonic source (hifigan.stream_synthesize);
    - synthesis groups follow the doubling schedule block_tokens ->
      throughput_block_tokens, so the same tokens give the same windows
      (and the same audio) however they were split into feed() calls.

    feed() takes a raw decoded block (EOS and other non-speech ids are
    dropped here) and returns the wav chunks that became emittable;
    finish() flushes the final window (lookahead included);
    seed_from_fused() resumes from the first-chunk program's carries.
    """

    def __init__(self, s3gen_params, prompt_token, prompt_feat, embedding, *, draws,
                 cfg: ChatterboxConfig = ChatterboxConfig(), dtype=torch.float32,
                 block_tokens: int = 25, throughput_block_tokens: int = 300,
                 ctx_tokens: int | None = None, voc_ctx: int | None = None):
        self.p = s3gen_params
        self.prompt_token = prompt_token
        self.prompt_feat = prompt_feat
        self.embedding = embedding
        self.device = embedding.device
        self.draws = draws
        self.cfg = cfg
        self.dtype = dtype
        self.C = STREAM_CTX_TOKENS if ctx_tokens is None else ctx_tokens
        self.M = STREAM_VOC_CTX_MEL if voc_ctx is None else voc_ctx
        s3c = cfg.s3gen
        self.r = s3c.flow.token_mel_ratio
        self.look = s3c.flow.pre_lookahead_len
        self.pin = self.r * (self.C - self.look)
        self.nmel = s3c.mel_num
        self.up = s3c.hift.total_upsample
        self.sizes = [block_tokens]
        while self.sizes[-1] < throughput_block_tokens:
            self.sizes.append(min(2 * self.sizes[-1], throughput_block_tokens))
        self.throughput_cap = throughput_block_tokens
        self.target = block_tokens
        self.pending = np.zeros((0,), np.int32)
        self.n = 0                                   # tokens consumed
        self.recent = np.zeros((0,), np.int32)       # the last <= C tokens
        self.mu_pin = torch.zeros((1, self.pin, self.nmel), device=self.device)
        self.mel_tail = torch.zeros((1, 0, self.nmel), device=self.device)
        self.phase = torch.zeros((1, s3c.hift.nb_harmonics + 1), device=self.device)
        self.first_voc = True
        self.vidx = 0                                # vocoder windows run

    def seed_from_fused(self, valid_tokens: np.ndarray, mu_tail, mel_tail,
                        phase_carry) -> None:
        """Resume after streaming.first_chunk synthesised the first group:
        its valid tokens, flow tail, vocoder context (the emitted frames'
        last <= M) and phase carry (the JAX package's seed_from_fused)."""
        self.n = len(valid_tokens)
        self.recent = np.asarray(valid_tokens, np.int32)[-self.C:]
        self.mu_pin = mu_tail
        self.mel_tail = torch.as_tensor(mel_tail, dtype=torch.float32, device=self.device)
        self.phase = phase_carry
        self.first_voc = False
        self.vidx = 1
        self.target = min(2 * self.sizes[0], self.throughput_cap)

    def _bucket_group(self, n: int) -> int:
        for s in self.sizes:
            if n <= s:
                return s
        return self.sizes[-1]

    def _synthesize(self, group: np.ndarray, final: bool):
        """One flow + vocoder window over `group` new tokens."""
        r, look, C, M, dev = self.r, self.look, self.C, self.M, self.device
        first = self.n == 0
        if first and len(group) == 0:
            return None
        ctx = self.recent if not first else np.zeros((0,), np.int32)
        gbkt = self._bucket_group(max(len(group), 1))
        win = np.zeros((1, len(ctx) + gbkt), np.int64)
        filled = np.concatenate([ctx, group])
        win[0, :len(filled)] = filled
        vlen = len(filled)
        n0 = self.n - len(ctx)
        mel_gen, mu_tail = s3gen_mod.flow_to_mel_window(
            self.p, torch.from_numpy(win).to(dev), torch.tensor([vlen], device=dev),
            self.prompt_token, self.prompt_feat, self.embedding, self.mu_pin,
            pin_frames=0 if first else self.pin, noise_off=r * n0, finalize=final,
            cfg=self.cfg.s3gen, dtype=self.dtype)
        self.mu_pin = mu_tail
        # the newly emittable frames of this window's generated region
        lo = r * max(len(ctx) - look, 0)
        hi = r * (vlen if final else vlen - look)
        self.n += len(group)
        self.recent = filled[-C:]
        if hi <= lo:
            return None
        mel_new = mel_gen[:, lo:hi]

        # vocoder window [M emitted context frames; new frames], zero-padded
        # to the group bucket's width
        valid_new = mel_new.shape[1]
        new_cap = r * (gbkt + look)      # final windows add the held-back lookahead
        m_eff = self.mel_tail.shape[1]
        mel_win = torch.zeros((1, m_eff + new_cap, self.nmel), device=dev)
        mel_win[:, :m_eff] = self.mel_tail
        mel_win[:, m_eff:m_eff + valid_new] = mel_new
        # the phase carry is read where the NEXT window starts: this
        # window's valid end minus the next context width
        m_next = min(M, m_eff + valid_new)
        carry_idx = max((m_eff + valid_new - m_next) * self.up - 1, 0)
        wav_win, carry = hift_mod.stream_synthesize(
            self.p["hift"], mel_win, self.draws, self.vidx, self.phase, carry_idx,
            cfg=self.cfg.s3gen.hift, dtype=self.dtype)
        self.phase = carry
        self.vidx += 1
        self.mel_tail = mel_win[:, max(m_eff + valid_new - M, 0): m_eff + valid_new]
        chunk = wav_win[0, m_eff * self.up:(m_eff + valid_new) * self.up].float().cpu().numpy()
        if self.first_voc:
            fade = s3gen_mod.trim_fade()
            chunk[: fade.shape[0]] *= fade
            self.first_voc = False
        return chunk

    def feed(self, block: np.ndarray) -> list:
        """Consume one decoded token block; return the newly emittable wav
        chunks (float32 numpy)."""
        block = np.asarray(block, np.int32).reshape(-1)
        block = block[block < SPEECH_VOCAB_SIZE]
        self.pending = np.concatenate([self.pending, block])
        chunks = []
        while len(self.pending) >= self.target:
            group, self.pending = self.pending[:self.target], self.pending[self.target:]
            chunk = self._synthesize(group, final=False)
            self.target = min(2 * self.target, self.throughput_cap)
            if chunk is not None and chunk.size:
                chunks.append(chunk)
        return chunks

    def finish(self) -> list:
        """Flush the final window (lookahead included)."""
        chunk = self._synthesize(self.pending, final=True)
        self.pending = np.zeros((0,), np.int32)
        return [chunk] if chunk is not None and chunk.size else []
