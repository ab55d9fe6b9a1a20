"""Continuous-batching TTS serving on the slot-refill T3 engine
(models/t3_engine.py), the PyTorch counterpart of
`chatterbox_embed_tpu/serving/continuous.py`.

Requests join a RUNNING decode the moment a slot frees. Per request: text ->
tokenizer -> engine slot (voice conditioning prefilled into the slot's cache
columns) -> completion -> S3Gen vocode, batched across whatever requests
completed recently (`vocode_batch`, flushed when the engine idles) through
`tts._vocode_batch`. A streamed request (`submit(stream=True)`) feeds its
slot's per-block tokens to a `streaming.WindowedSynth` instead.
`ContinuousStoryServer` runs whole stories: chunked on arrival, each chunk
through the engine with the long-text gates and retry drift, stitched and
watermarked when its last chunk lands.

Draws: `make_draws(seed)` (default `Draws(seed, device)`) serves a
request's T3 steps (seed + 1000 * tries for a retry), a streamed request's
vocoder windows, and each vocode dispatch (the seed of its first request).

Two faults of the JAX package's copy are not carried over (ROADMAP §3):
`take_stream` records an id only while its stream exists, so the set of
ids does not grow for ids never streamed; and the engine's idle step clears
`last_block_tokens`.
"""
from __future__ import annotations

import functools
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import SPEECH_VOCAB_SIZE
from ..models import llama
from ..models import t3 as t3_mod
from ..models import t3_engine
from ..models.t3_engine import ContinuousDecoder
from ..ops.sampling import Draws
from ..utils import profiling

logger = logging.getLogger(__name__)

# below this many cleaned speech tokens a decode is considered failed
# (tts._guard_tokens) and the request is retried with a drifted seed
MIN_TOKENS = 8


class ContinuousServer:
    """Submit / pump / drain server over a ChatterboxTTS.

    Args:
      tts: a ChatterboxTTS (weights, tokenizer, S3Gen), on its device.
      slots: concurrent decode slots (2 * slots CFG rows); default
        t3.max_decode_utterances at the engine's capacity, at most 16.
      text_bucket: engine-wide text width; longer requests are refused.
      max_new_tokens: each slot's token capacity (requests may ask less).
      block: decode steps between refills.
      vocode_batch: completions are vocoded once this many are ready, or
        when the engine idles.
      retries: seed-drift retries of too-short decodes.
      kv_int8: the engine's int8 cache; None follows CHATTERBOX_INT8_KV.
        The default slots are sized against the cache the engine will
        allocate (an explicit value overrides the setting).
      make_draws: draw-source factory (module docstring); on a mesh it must
        pickle.
      route_record: a latent backbone's engine keeps each finished
        request's expert ids (`ContinuousDecoder.routes`; on a hybrid
        backbone a `t3_engine.KdaRoute` with its first KDA layer's state),
        moved to `routes` {external rid: ids} as the request completes; the
        caller pops them.

    On a mesh-enabled pipeline (`tts.enable_mesh`) the engine runs over
    `tts.mesh`: the default slot count is dp times the one-card default
    (each rank holds slots / dp of them), explicit slots must divide dp,
    and streamed requests are refused (the windowed synthesis is one
    card's, as `stream_generate`). S3Gen runs here, on the leader.
    """

    def __init__(self, tts, *, slots: Optional[int] = None, text_bucket: int = 192,
                 max_new_tokens: int = 600, block: int = 64, vocode_batch: int = 8,
                 use_top_p: bool = False, kv_int8: Optional[bool] = None, retries: int = 1,
                 retain_wavs: bool = True,
                 make_draws: Optional[Callable[[int], object]] = None,
                 route_record: bool = False):
        self.tts = tts
        self.make_draws = make_draws or functools.partial(Draws, device=tts.device)
        mesh = getattr(tts, "mesh", None)
        dp = 1 if mesh is None else mesh.dp
        if slots is None:
            _, capacity = t3_engine.engine_geometry(
                tts.cfg.t3, text_bucket, 2 + tts.cfg.t3.perceiver_num_queries, max_new_tokens)
            eff_int8 = llama._kv_int8_mode() > 0 if kv_int8 is None else kv_int8
            slots = min(16, t3_mod.max_decode_utterances(
                capacity, cfg=tts.cfg.t3, dtype=tts.dtype, kv_int8=eff_int8,
                free_bytes=t3_mod.free_device_bytes(tts.device))) * dp
        elif slots % dp != 0:
            raise ValueError(f"slots={slots} must be a multiple of the dp "
                             f"axis ({dp}) — each chip hosts slots/dp slots")
        self.decoder = ContinuousDecoder(
            tts.t3_params, tts.cfg.t3, slots=slots, text_bucket=text_bucket,
            max_new_tokens=max_new_tokens, block=block, dtype=tts.dtype, kv_int8=kv_int8,
            use_top_p=use_top_p, retain_results=False, make_draws=self.make_draws,
            device=tts.device, mesh=mesh, route_record=route_record)
        self.vocode_batch = vocode_batch
        self.retries = retries
        # a run-forever caller consumes results from pump()'s return value;
        # retain_wavs=False keeps every wav from accumulating here
        self.retain_wavs = retain_wavs
        self._meta: Dict[int, dict] = {}      # engine rid -> request
        self._ext_of: Dict[int, int] = {}     # engine rid -> external rid
        # completed, not yet vocoded: (ext rid, tokens, conds, seed)
        self._ready: List[Tuple[int, np.ndarray, object, int]] = []
        self._wavs: Dict[int, np.ndarray] = {}
        self._failed: Dict[int, str] = {}
        self.routes: Dict[int, np.ndarray] = {}
        # streamed requests: engine rid -> WindowedSynth; ext rid -> chunks
        self._streams: Dict[int, object] = {}
        self._schunks: Dict[int, List[np.ndarray]] = {}
        self._staken: Dict[int, int] = {}
        self._sdone: set = set()
        # streamed requests whose consumer has called take_stream: only their
        # chunk buffers outlive completion (for the final take)
        self._stouched: set = set()

    # -- submission -----------------------------------------------------

    def submit(self, text: str, conds=None, *, temperature: float = 0.6,
               cfg_weight: float = 0.3, repetition_penalty: float = 1.2, min_p: float = 0.05,
               top_p: float = 1.0, exaggeration: Optional[float] = None, seed: int = 0,
               max_new_tokens: Optional[int] = None, stream: bool = False,
               stream_block_tokens: Optional[int] = None) -> int:
        """Queue one utterance; returns an external request id whose wav
        appears in pump() / drain().

        stream=True: the audio is synthesised as the slot's blocks decode
        (take_stream gives the new chunks); the completed wav is their
        concatenation. Streamed requests skip the retry and the batched
        vocode. stream_block_tokens: the first synthesis group (default
        the engine block)."""
        conds = conds if conds is not None else self.tts.conds
        if conds is None:
            raise RuntimeError("prepare conditionals (or pass conds=)")
        if stream and getattr(self.tts, "mesh", None) is not None:
            raise ValueError(
                "submit(stream=True) is not supported on a mesh-enabled "
                "server — streaming synthesis is single-chip "
                "(tts.stream_generate docstring); run streamed requests on "
                "an unmeshed ContinuousServer")
        conds = conds.to(self.tts.device)
        sot = self.tts.cfg.t3.start_text_token
        eot = self.tts.cfg.t3.stop_text_token
        tok = self.tts.tokenizer.text_to_tokens(text)[0]
        text_tokens = np.concatenate([[sot], tok, [eot]]).astype(np.int32)[None]
        t3c = conds.t3
        if exaggeration is not None:
            t3c = t3c._replace(emotion_adv=float(exaggeration))
        req = dict(text_tokens=text_tokens, t3c=t3c, conds=conds, temperature=temperature,
                   cfg_weight=cfg_weight, repetition_penalty=repetition_penalty, min_p=min_p,
                   top_p=top_p, seed=seed, max_new_tokens=max_new_tokens, tries=0)
        rid = self._submit_engine(req)
        self._ext_of[rid] = rid
        if stream:
            from ..streaming import WindowedSynth
            prompt_token, prompt_feat, embedding = self.tts._gen_tensors(conds.gen)
            self._streams[rid] = WindowedSynth(
                self.tts.s3gen_params, prompt_token, prompt_feat, embedding,
                draws=self.make_draws(seed), cfg=self.tts.cfg, dtype=self.tts.dtype,
                block_tokens=stream_block_tokens or self.decoder.block)
            self._schunks[rid] = []
            self._staken[rid] = 0
        return rid

    def take_stream(self, ext: int) -> List[np.ndarray]:
        """New audio chunks of a streamed request since the last call ([]
        when nothing is new or the id has no stream). After the request
        completes, the final call returns the rest and releases the
        buffers. A consumer that never calls this before completion gets the
        full wav from pump() and its buffers are freed then."""
        ch = self._schunks.get(ext)
        if ch is None:
            return []
        k = self._staken.get(ext, 0)
        new = ch[k:]
        if ext in self._sdone:
            self._schunks.pop(ext, None)
            self._staken.pop(ext, None)
            self._sdone.discard(ext)
            self._stouched.discard(ext)
        else:
            self._stouched.add(ext)
            self._staken[ext] = len(ch)
        return new

    def _submit_engine(self, req: dict) -> int:
        rid = self.decoder.submit(
            req["text_tokens"], req["t3c"], temperature=req["temperature"],
            cfg_weight=req["cfg_weight"], repetition_penalty=req["repetition_penalty"],
            min_p=req["min_p"], top_p=req["top_p"], seed=req["seed"] + 1000 * req["tries"],
            max_new_tokens=req["max_new_tokens"])
        self._meta[rid] = req
        return rid

    # -- serving loop -----------------------------------------------------

    @property
    def idle(self) -> bool:
        return self.decoder.idle and not self._ready

    def pump(self) -> Dict[int, np.ndarray]:
        """One engine block and any vocode flush. Returns {external rid:
        wav} for requests whose audio finished in this call."""
        with profiling.span("server.pump"):
            done = self.decoder.step()
            out: Dict[int, np.ndarray] = {}
            for rid, synth in list(self._streams.items()):
                toks = self.decoder.last_block_tokens.get(rid)
                ext = self._ext_of.get(rid, rid)
                if toks is not None and toks.size:
                    self._schunks[ext].extend(synth.feed(toks))
                if rid in done:
                    self._schunks[ext].extend(synth.finish())
                    del self._streams[rid]
                    self._meta.pop(rid, None)
                    self._ext_of.pop(rid, None)
                    chunks = self._schunks[ext]
                    wav = np.concatenate(chunks) if chunks else np.zeros((0,), np.float32)
                    if ext in self._stouched:
                        # an active take_stream consumer: keep the untaken tail
                        self._sdone.add(ext)
                    else:
                        self._schunks.pop(ext, None)
                        self._staken.pop(ext, None)
                    if wav.size == 0:
                        self._failed[ext] = "empty streamed decode"
                    else:
                        if self.retain_wavs:
                            self._wavs[ext] = wav
                        out[ext] = wav
                    del done[rid]
            for rid, toks in done.items():
                req = self._meta.pop(rid)
                ext = self._ext_of.pop(rid)
                if rid in self.decoder.routes:
                    self.routes[ext] = self.decoder.routes.pop(rid)
                clean = toks[toks < SPEECH_VOCAB_SIZE]
                if clean.size < MIN_TOKENS and req["tries"] < self.retries:
                    req["tries"] += 1
                    logger.warning("request %s produced %d tokens; retrying (%d/%d)", ext,
                                   clean.size, req["tries"], self.retries)
                    self._ext_of[self._submit_engine(req)] = ext
                    continue
                if clean.size == 0:
                    self._failed[ext] = "empty decode after retries"
                    continue
                self._ready.append((ext, toks, req["conds"], req["seed"]))
            if self._ready and (len(self._ready) >= self.vocode_batch or self.decoder.idle):
                batch, self._ready = self._ready, []
                samples = 0
                with profiling.span("server.vocode", rids=[ext for ext, *_ in batch]):
                    try:
                        wavs, _, _ = self.tts._vocode_batch(
                            [t for _, t, _, _ in batch], conds_list=[c for _, _, c, _ in batch],
                            seed=int(batch[0][3]), make_draws=self.make_draws)
                    except Exception:
                        # keep the completed decodes for the next pump's flush
                        self._ready = batch + self._ready
                        raise
                    for (ext, _t, _c, _s), wav in zip(batch, wavs):
                        if self.retain_wavs:
                            self._wavs[ext] = wav
                        out[ext] = wav
                        samples += wav.size
                profiling.count("vocode.rows", len(batch))
                profiling.count("vocode.audio_samples", samples)
            return out

    def drain(self) -> Dict[int, np.ndarray]:
        """Run until every submitted request has audio or failed; returns
        the wavs retained so far (failures in .failed)."""
        while not self.idle:
            self.pump()
        return dict(self._wavs)

    @property
    def failed(self) -> Dict[int, str]:
        return dict(self._failed)

    def take_failures(self) -> Dict[int, str]:
        """Pop the failures recorded since the last call (the failure
        channel of a run-forever pump loop)."""
        out, self._failed = self._failed, {}
        return out


# ---------------------------------------------------------------------------
# job-level continuous serving (whole stories through the engine)
# ---------------------------------------------------------------------------

@dataclass
class _StoryJob:
    """One in-flight story: its chunks ride the engine independently."""
    chunks: list                               # List[ChunkInfo]
    per_chunk: List[Dict[str, float]]          # adaptive params per chunk
    conds: Any                                 # Conditionals
    seed: int
    pause_scale: Optional[float]
    t0: float
    max_new: Optional[int] = None
    wavs: List[Optional[np.ndarray]] = field(default_factory=list)
    last_wav: List[Optional[np.ndarray]] = field(default_factory=list)
    attempts: List[int] = field(default_factory=list)
    pending: int = 0
    regenerations: int = 0


class ContinuousStoryServer:
    """Arrival-driven story serving on the slot-refill engine: each story
    is chunked on arrival and its chunks join the running decode. Per-chunk
    adaptive parameters (`tts._adaptive_chunk_params`), the chunk gates
    (`tts._chunk_gates_ok` and the 8-token floor), failed chunks re-entering
    the engine with the retry drift and seed + 1000 * attempt + chunk id,
    and the finish of `generate_long_text` (stitch, watermark, metadata)
    once a story's last chunk passes. Stories may carry different voices."""

    def __init__(self, tts, *, slots: Optional[int] = None, text_bucket: int = 256,
                 max_new_tokens: int = 1000, block: int = 64, vocode_batch: int = 4,
                 max_attempts: Optional[int] = None,
                 make_draws: Optional[Callable[[int], object]] = None):
        self.tts = tts
        self.srv = ContinuousServer(
            tts, slots=slots, text_bucket=text_bucket, max_new_tokens=max_new_tokens,
            block=block, vocode_batch=vocode_batch, use_top_p=True, retries=1,
            retain_wavs=False, make_draws=make_draws)   # this layer owns result lifetimes
        self.text_bucket = text_bucket
        self.max_attempts = (int(os.getenv("CHATTERBOX_CHUNK_REGEN_ATTEMPTS", "4"))
                             if max_attempts is None else max_attempts)
        self._jobs: Dict[int, _StoryJob] = {}
        self._rid_map: Dict[int, Tuple[int, int, int]] = {}  # rid -> (jid, ci, attempt)
        self._next_jid = 0

    # -- submission ---------------------------------------------------------

    def submit_story(self, text: str, conds, *, exaggeration: float = 0.5,
                     cfg_weight: float = 0.6, temperature: float = 0.7,
                     target_chars: int = 400, max_chars: int = 600, seed: int = 0,
                     pause_scale: Optional[float] = None,
                     max_new_tokens: Optional[int] = None,
                     adaptive_voice_param_blend: float = 0.2) -> int:
        """Chunk one story and queue every chunk; returns a job id whose
        (wav, metadata) appears in pump() / drain(). Raises ValueError
        before anything enters the engine if the story has no
        synthesisable text or any chunk exceeds the text bucket."""
        tts = self.tts
        chunks = tts.chunk_text(text, target_chars, max_chars)
        if not chunks:
            raise ValueError("no synthesisable text after sanitisation")
        base = dict(exaggeration=exaggeration, cfg_weight=cfg_weight, temperature=temperature,
                    repetition_penalty=1.2, min_p=0.05, top_p=1.0)
        blend = tts.experiment_config.get("force_adaptive_blend")
        if blend is None:
            blend = adaptive_voice_param_blend
        per_chunk = tts._adaptive_chunk_params(chunks, base, blend)
        for info in chunks:       # atomic: nothing is submitted if one will not fit
            n_tok = len(tts.tokenizer.text_to_tokens(info.text)[0]) + 2
            if n_tok > self.text_bucket:
                raise ValueError(f"chunk {info.id} is {n_tok} tokens; engine bucket is "
                                 f"{self.text_bucket}: use the lock-step path or a wider "
                                 "engine")
        jid = self._next_jid
        self._next_jid += 1
        n = len(chunks)
        self._jobs[jid] = _StoryJob(chunks=chunks, per_chunk=per_chunk, conds=conds, seed=seed,
                                    pause_scale=pause_scale, t0=time.time(),
                                    max_new=max_new_tokens, wavs=[None] * n,
                                    last_wav=[None] * n, attempts=[0] * n, pending=n)
        for ci in range(n):
            self._submit_chunk(jid, ci, attempt=0)
        return jid

    def _submit_chunk(self, jid: int, ci: int, attempt: int):
        job = self._jobs[jid]
        info = job.chunks[ci]
        p = dict(job.per_chunk[ci])
        if attempt > 0 and self.tts.experiment_config.get("enable_retry_param_drift", True):
            p["temperature"] = max(0.5, p["temperature"] - 0.08 * attempt)
            p["cfg_weight"] = min(0.8, p["cfg_weight"] + 0.08 * attempt)
            p["exaggeration"] = max(0.1, p["exaggeration"] - 0.05 * attempt)
        rid = self.srv.submit(
            info.text, job.conds, temperature=p["temperature"], cfg_weight=p["cfg_weight"],
            repetition_penalty=p["repetition_penalty"], min_p=p["min_p"], top_p=p["top_p"],
            exaggeration=p.get("exaggeration"), seed=job.seed + attempt * 1000 + info.id,
            max_new_tokens=job.max_new)
        self._rid_map[rid] = (jid, ci, attempt)

    # -- serving loop -------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self._jobs and self.srv.idle

    def pump(self) -> Dict[int, Tuple[np.ndarray, Dict[str, Any]]]:
        """One engine block; gates the chunk audio that landed; returns
        {job id: (wav (1, T), metadata)} for the stories that finished."""
        finished: Dict[int, Optional[np.ndarray]] = dict(self.srv.pump())
        # an empty decode after the inner retry gates as a silent take
        for rid in self.srv.take_failures():
            finished[rid] = None
        out: Dict[int, Tuple[np.ndarray, Dict[str, Any]]] = {}
        for rid, wav in finished.items():
            if rid not in self._rid_map:
                logger.warning("dropping result for unknown request %s", rid)
                continue
            jid, ci, attempt = self._rid_map.pop(rid)
            job = self._jobs[jid]
            if self._gate_chunk(jid, job, ci, attempt, wav):
                job.pending -= 1
            if job.pending == 0:
                out[jid] = self._finalize(jid, job)
        return out

    def _gate_chunk(self, jid: int, job: _StoryJob, ci: int, attempt: int,
                    wav: Optional[np.ndarray]) -> bool:
        """Accept or retry one landed take; True when the chunk is done
        (tts._generate_single_chunk_with_quality's rules)."""
        info = job.chunks[ci]
        flat = None if wav is None else np.asarray(wav).reshape(-1)
        if flat is not None:
            job.last_wav[ci] = flat
        job.attempts[ci] = attempt + 1
        # the token guard's floor in samples (8 tokens x 2 mel frames x 480)
        if flat is None or flat.size < 8 * 2 * 480:
            ok, reason = False, "silence"
        else:
            ok, reason = self.tts._chunk_gates_ok(flat, info)
        last_try = attempt >= self.max_attempts - 1
        if ok or (reason == "qa" and last_try):
            job.wavs[ci] = flat
            return True
        if not last_try:
            logger.info("job %d chunk %d %s: re-entering the engine (attempt %d/%d)", jid,
                        ci, reason or "retry", attempt + 2, self.max_attempts)
            job.regenerations += 1
            self._submit_chunk(jid, ci, attempt + 1)
            return False
        # exhausted: keep the last take, else half a second of silence
        job.wavs[ci] = (job.last_wav[ci] if job.last_wav[ci] is not None
                        else np.zeros(self.tts.sr // 2, np.float32))
        logger.warning("job %d chunk %d failed after %d attempts; keeping the last take",
                       jid, ci, self.max_attempts)
        return True

    def _finalize(self, jid: int, job: _StoryJob) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Stitch, watermark and metadata, as generate_long_text."""
        from ..tts import CHATTERBOX_RUNTIME_VERSION
        tts = self.tts
        del self._jobs[jid]
        stitcher = tts.advanced_stitcher
        prev = stitcher.global_pause_factor
        if job.pause_scale is not None:
            stitcher.global_pause_factor = job.pause_scale
        try:
            wav, sr, duration = tts.stitch_and_normalize(job.wavs, job.chunks)
        finally:
            stitcher.global_pause_factor = prev
        wav = tts.watermarker.apply_watermark(wav, sample_rate=sr)
        total = time.time() - job.t0
        eng = self.srv.decoder
        metadata = {
            "runtime_version": CHATTERBOX_RUNTIME_VERSION,
            "num_chunks": len(job.chunks),
            "duration_s": duration,
            "generation_time_s": total,
            "audio_ratio": duration / total if total > 0 else 0.0,
            "cache_stats": tts.get_conditional_cache_stats(),
            "chunk_stats": {
                "chunks": [{"id": info.id, "attempts": job.attempts[i],
                            "samples": int(job.wavs[i].size), "params": job.per_chunk[i]}
                           for i, info in enumerate(job.chunks)],
                "regenerations": job.regenerations,
                "continuous": True,
            },
            # the engine's counters, shared by interleaved jobs
            "engine": {"blocks_run": eng.blocks_run, "steps_run": eng.steps_run,
                       "slots": eng.slots},
        }
        return wav[None, :], metadata

    def drain(self) -> Dict[int, Tuple[np.ndarray, Dict[str, Any]]]:
        """Run until every submitted story has audio; returns all of them."""
        out: Dict[int, Tuple[np.ndarray, Dict[str, Any]]] = {}
        while not self.idle:
            out.update(self.pump())
        return out
