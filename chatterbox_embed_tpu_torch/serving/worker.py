"""Redis Streams job worker, the port's own copy of
`chatterbox_embed_tpu/serving/worker.py` (reference: worker_redis.py:17-175 —
consumer groups, 5 s blocking reads, per-job status hash, dead-letter stream).

The model comes from `tts_factory` / `vc_factory`, by default
ChatterboxTTS.from_pretrained / ChatterboxVC.from_pretrained (the
checkpoints from the Hugging Face hub, on the card), as in the JAX
worker. Where the port differs: WORKER_MESH=dpxtp (e.g.
"2x4") serves T3 over a dp x tp mesh (`tts.enable_mesh(n_devices=dp * tp,
tp=tp)`, on the first dp * tp cards unless `mesh_device` names one device
for every rank); the worker still reads its stream from this one process.
A malformed value raises when the worker is built, and a model without
`enable_mesh` raises, where the JAX worker would skip the mesh silently.

redis-py is optional: when missing, an in-process queue backend with the same
stream semantics lets the worker loop run in tests and hermetic environments.
The distribution model is the reference's: one worker process per accelerator,
data parallelism over requests via consumer groups (SURVEY.md §2.6).
"""
from __future__ import annotations

import json
import logging
import os
import time
import uuid
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

STREAM_TTS = "runpod:jobs:tts"
STREAM_VC = "runpod:jobs:vc"
DLQ_STREAM = "runpod:dlq"


class InMemoryStreams:
    """Minimal Redis-Streams-compatible backend (xadd/xreadgroup/xack/hset)."""

    def __init__(self):
        self.streams: Dict[str, List[Tuple[str, Dict[str, str]]]] = defaultdict(list)
        self.delivered: Dict[Tuple[str, str], set] = defaultdict(set)
        self.acked: Dict[Tuple[str, str], set] = defaultdict(set)
        self.hashes: Dict[str, Dict[str, str]] = defaultdict(dict)

    def xadd(self, stream: str, fields: Dict[str, str]) -> str:
        mid = f"{int(time.time() * 1000)}-{len(self.streams[stream])}"
        self.streams[stream].append((mid, dict(fields)))
        return mid

    def xgroup_create(self, stream: str, group: str, id: str = "0", mkstream=False):
        return True

    def xreadgroup(self, group: str, consumer: str, streams: Dict[str, str],
                   count: int = 1, block: int = 0):
        out = []
        for stream in streams:
            key = (stream, group)
            pending = [(m, f) for m, f in self.streams[stream]
                       if m not in self.delivered[key]]
            take = pending[:count]
            for m, _ in take:
                self.delivered[key].add(m)
            if take:
                out.append((stream, take))
        return out

    def xack(self, stream: str, group: str, mid: str):
        self.acked[(stream, group)].add(mid)

    def hset(self, name: str, mapping: Dict[str, str]):
        self.hashes[name].update(mapping)

    def hgetall(self, name: str) -> Dict[str, str]:
        return dict(self.hashes[name])


def _connect_redis():
    try:
        import redis  # type: ignore
        return redis.Redis(
            host=os.getenv("REDIS_HOST", "localhost"),
            port=int(os.getenv("REDIS_PORT", "6379")),
            password=os.getenv("REDIS_PASSWORD") or None,
            db=int(os.getenv("REDIS_DB", "0")),
            decode_responses=True,
        )
    except ImportError:
        logger.warning("redis-py unavailable; using in-memory stream backend")
        return InMemoryStreams()


def _mesh_spec(raw: Optional[str]) -> Optional[Tuple[int, int]]:
    """WORKER_MESH "dpxtp" -> (dp, tp); unset or empty -> None; anything
    else raises."""
    if not raw:
        return None
    parts = raw.strip().lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"WORKER_MESH={raw!r}: want dpxtp with two positive integers, "
                         "e.g. 2x4")
    return int(parts[0]), int(parts[1])


class RedisWorker:
    """Consume TTS / voice-clone jobs from a stream and run them.
    mesh_device: where WORKER_MESH's ranks run (None: the cards)."""

    def __init__(self, mode: str = "tts", client=None,
                 tts_factory: Optional[Callable] = None,
                 vc_factory: Optional[Callable] = None, mesh_device=None):
        assert mode in ("tts", "vc")
        self.mesh_spec = _mesh_spec(os.getenv("WORKER_MESH"))
        self.mesh_device = mesh_device
        self.mode = mode
        self.stream = STREAM_TTS if mode == "tts" else STREAM_VC
        self.group = os.getenv("REDIS_CONSUMER_GROUP", "workers")
        self.consumer = os.getenv("REDIS_CONSUMER_NAME", f"worker-{uuid.uuid4().hex[:8]}")
        self.client = client or _connect_redis()
        self._tts_factory = tts_factory
        self._vc_factory = vc_factory
        self._tts = None
        self._vc = None
        try:
            self.client.xgroup_create(self.stream, self.group, id="0", mkstream=True)
        except Exception:
            pass  # group exists

    # -- job payloads: flattened payload:* fields or one JSON blob
    @staticmethod
    def parse_payload(fields: Dict[str, str]) -> Dict[str, Any]:
        if "payload" in fields:
            return json.loads(fields["payload"])
        payload = {}
        for k, v in fields.items():
            if k.startswith("payload:"):
                payload[k.split(":", 1)[1]] = v
        return payload

    def set_status(self, job_id: str, status: str, **extra):
        self.client.hset(f"runpod:job:{job_id}",
                         mapping={"status": status, "updated_at": str(time.time()), **extra})

    def _get_tts(self):
        if self._tts is None:
            if self._tts_factory is None:
                from ..tts import ChatterboxTTS
                self._tts_factory = ChatterboxTTS.from_pretrained
            self._tts = self._tts_factory()
            if os.getenv("WORKER_WARMUP", "0") == "1" and hasattr(self._tts, "warmup"):
                # build the serving kernels and run the deployment's buckets
                # before taking traffic
                def _ints(key, default):
                    raw = os.getenv(key)
                    if not raw:
                        return default
                    return tuple(int(x) for x in raw.split(",") if x.strip())
                self._tts.warmup(
                    batch_sizes=_ints("WORKER_WARMUP_BATCHES", (1,)),
                    token_buckets=_ints("WORKER_WARMUP_TOKEN_BUCKETS", (256,)),
                    stream=os.getenv("WORKER_WARMUP_STREAM", "0") == "1")
            if self.mesh_spec is not None:
                dp, tp = self.mesh_spec
                self._tts.enable_mesh(n_devices=dp * tp, tp=tp, device=self.mesh_device)
        return self._tts

    def _get_vc(self):
        if self._vc is None:
            if self._vc_factory is None:
                from ..vc import ChatterboxVC
                self._vc_factory = ChatterboxVC.from_pretrained
            self._vc = self._vc_factory()
        return self._vc

    def process_message(self, mid: str, fields: Dict[str, str]) -> bool:
        payload = self.parse_payload(fields)
        job_id = payload.get("job_id", mid)
        job_type = payload.get("type", self.mode)
        self.set_status(job_id, "processing")
        try:
            if job_type == "tts":
                result = self._get_tts().generate_tts_story(**{
                    k: payload[k] for k in
                    ("story_id", "user_id", "text", "voice_profile_b64",
                     "voice_profile_r2_key", "language", "version_id",
                     "voice_id", "voice_name", "story_type", "is_kids_voice",
                     "pause_scale", "metadata", "exaggeration", "cfg_weight",
                     "temperature")
                    if k in payload})
            elif job_type == "vc":
                from ..vc import clone_voice
                result = clone_voice(self._get_vc(), **{
                    k: payload[k] for k in
                    ("voice_id", "voice_name", "user_id", "audio_b64", "audio_r2_key",
                     "language", "metadata")
                    if k in payload})
            else:
                raise ValueError(f"unknown job type: {job_type}")
            if isinstance(result, dict) and result.get("status") == "error":
                # jobs catch their own exceptions and report via the payload
                # (reference: tts.py:1790-1799); surface that as a job failure
                raise RuntimeError(result.get("error", "job reported error"))
            self.set_status(job_id, "done", result=json.dumps(result, default=str))
            return True
        except Exception as e:  # noqa: BLE001 — worker must survive bad jobs
            logger.exception("job %s failed", job_id)
            self.set_status(job_id, "error", error=str(e))
            self.client.xadd(DLQ_STREAM, {"source": self.stream, "job_id": job_id,
                                          "error": str(e)})
            return False

    def process_batch(self, items: List[Tuple[str, Dict[str, Any]]]) -> int:
        """Run several parsed TTS payloads as ONE pooled decode
        (jobs.generate_tts_stories_batch); per-job status/DLQ contract is
        identical to process_message. Returns the number handled."""
        from . import jobs
        for mid, payload in items:
            self.set_status(payload.get("job_id", mid), "processing")
        try:
            results = jobs.generate_tts_stories_batch(
                self._get_tts(), [p for _, p in items])
        except Exception as e:  # noqa: BLE001 — batch layer must survive
            logger.exception("batched job pass failed")
            results = [{"status": "error", "error": str(e)}] * len(items)
        for (mid, payload), result in zip(items, results):
            job_id = payload.get("job_id", mid)
            if isinstance(result, dict) and result.get("status") != "error":
                self.set_status(job_id, "done",
                                result=json.dumps(result, default=str))
            else:
                err = (result or {}).get("error", "job reported error")
                logger.error("job %s failed: %s", job_id, err)
                self.set_status(job_id, "error", error=str(err))
                self.client.xadd(DLQ_STREAM, {"source": self.stream,
                                              "job_id": job_id,
                                              "error": str(err)})
        return len(items)

    def run_once(self) -> int:
        """Process up to WORKER_MAX_BATCH messages; returns number handled.

        With WORKER_MAX_BATCH=1 (the default) this is the reference's
        one-job-at-a-time loop. Above 1, waiting TTS jobs are drained into
        one pooled multi-voice decode (dynamic batching — the chip's batch
        budget fills across jobs instead of idling at B=1); non-TTS or
        malformed messages keep the single-job path."""
        max_batch = int(os.getenv("WORKER_MAX_BATCH", "1"))
        msgs = self.client.xreadgroup(self.group, self.consumer,
                                      {self.stream: ">"}, count=max(1, max_batch),
                                      block=5000)
        entries = [(mid, fields) for _stream, es in msgs or [] for mid, fields in es]
        handled = 0
        batchable: List[Tuple[str, Dict[str, Any]]] = []
        for mid, fields in entries:
            payload = None
            if self.mode == "tts" and len(entries) > 1:
                try:
                    payload = self.parse_payload(fields)
                except Exception:  # noqa: BLE001 — fall through to single path
                    payload = None
            if payload is not None and payload.get("type", self.mode) == "tts":
                batchable.append((mid, payload))
            else:
                self.process_message(mid, fields)
                self.client.xack(self.stream, self.group, mid)
                handled += 1
        if len(batchable) == 1:
            mid, payload = batchable[0]
            self.process_message(mid, {"payload": json.dumps(payload)})
            self.client.xack(self.stream, self.group, mid)
            handled += 1
        elif batchable:
            handled += self.process_batch(batchable)
            for mid, _ in batchable:
                self.client.xack(self.stream, self.group, mid)
        return handled

    # -- continuous serving (arrival-driven, slot-refill engine) -----------

    @staticmethod
    def continuous_enabled() -> bool:
        """WORKER_CONTINUOUS gate for run_forever's TTS loop. DEFAULT ON
        since round 4: under Poisson arrivals at 80% capacity the slot-refill
        engine wins 6.5x mean / 36x p95 latency at 5.5x better makespan vs
        WORKER_MAX_BATCH pooling (PERF_NOTES.md q4aa), and the worker-level
        full-size TPU smoke (scripts/continuous_worker_smoke.py,
        measurements/q4ab_cont_worker.log) validated the whole path —
        jobs in (one arriving mid-decode) -> engine decode -> gates ->
        stitch -> storage/status/ack. Kill-switch WORKER_CONTINUOUS=0
        restores the pooled lock-step loop (still the right mode when all
        jobs are known upfront — q4z: lock-step wins 0-10% tokens/s on
        static deep queues)."""
        return os.getenv("WORKER_CONTINUOUS", "1") not in ("0", "false", "no")

    def _conds_for_profile(self, payload: Dict[str, Any],
                           cache: Dict[str, Any]):
        """Conditionals for a job's voice profile, LRU-cached across jobs by
        profile SOURCE (b64 payload / R2 key — the same dedupe key
        jobs.generate_tts_stories_batch uses). Safe to ignore exaggeration in
        the key: the engine overrides emotion_adv per chunk, and the S3Gen
        reference dict does not depend on it."""
        import hashlib

        from . import jobs as jobs_mod
        b64 = payload.get("voice_profile_b64")
        r2key = payload.get("voice_profile_r2_key")
        # the bucket is part of an R2 key's identity (same key, different
        # bucket = different voice); inline b64 bytes are bucket-independent
        bucket = (payload.get("bucket") or "") if r2key else ""
        key = hashlib.sha1(
            (b64 or "").encode() + b"|" + (r2key or "").encode()
            + b"|" + bucket.encode()).hexdigest()
        if key in cache:
            return cache[key]
        path = jobs_mod._fetch_profile(b64, r2key, payload.get("bucket"))
        try:
            conds = self._get_tts()._get_or_prepare_conditionals(
                voice_profile_path=path,
                exaggeration=float(payload.get("exaggeration", 0.5)))
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass
        if len(cache) >= 8:
            cache.pop(next(iter(cache)))
        cache[key] = conds
        return conds

    def _continuous_intake(self, srv, live: Dict[int, Dict[str, Any]],
                           conds_cache: Dict[str, Any], mid: str,
                           fields: Dict[str, str]) -> int:
        """Admit one message into the running engine. TTS jobs are chunked
        and their chunks join the current decode; anything else (VC jobs,
        malformed payloads, chunks wider than the engine bucket) falls back
        to the lock-step single-job path so the job still completes.
        Returns 1 when the message was fully handled here, 0 when it joined
        the engine (acked at completion)."""
        from . import jobs as jobs_mod
        try:
            payload = self.parse_payload(fields)
        except Exception:  # noqa: BLE001 — malformed: single path reports it
            payload = None
        if payload is None or payload.get("type", self.mode) != "tts":
            self.process_message(mid, fields)
            self.client.xack(self.stream, self.group, mid)
            return 1
        job_id = payload.get("job_id", mid)
        self.set_status(job_id, "processing")
        try:
            missing = [k for k in ("text", "story_id", "user_id")
                       if k not in payload]
            if missing:
                raise ValueError(f"missing required fields: {missing}")
            story_type, voice_name, _meta, update_fs = \
                jobs_mod._normalize_story_fields(
                    payload.get("story_type", "user"),
                    payload.get("voice_name", ""),
                    payload.get("voice_id", ""),
                    payload.get("metadata"),
                    payload.get("update_firestore"))
            conds = self._conds_for_profile(payload, conds_cache)
            jid = srv.submit_story(
                payload["text"], conds,
                exaggeration=float(payload.get("exaggeration", 0.5)),
                cfg_weight=float(payload.get("cfg_weight", 0.6)),
                temperature=float(payload.get("temperature", 0.7)),
                pause_scale=float(payload.get("pause_scale", 1.15)),
                seed=int(payload.get("seed", 0)))
            live[jid] = dict(mid=mid, payload=payload, t0=time.time(),
                             norm=dict(story_type=story_type,
                                       voice_name=voice_name,
                                       update_firestore=update_fs))
            return 0
        except Exception as e:  # noqa: BLE001 — fall back, never drop a job
            logger.warning("continuous intake failed for %s (%s); running "
                           "the lock-step path", job_id, e)
            self.process_message(mid, {"payload": json.dumps(payload)})
            self.client.xack(self.stream, self.group, mid)
            return 1

    def _continuous_finish(self, rec: Dict[str, Any], wav, meta) -> None:
        """Upload + status for one finished story (same contract as
        process_message: done/error status hash, DLQ on failure, ack last)."""
        from . import jobs as jobs_mod
        payload, mid = rec["payload"], rec["mid"]
        job_id = payload.get("job_id", mid)
        try:
            result = jobs_mod._finish_story_job(
                self._get_tts(), wav, meta, rec["t0"],
                story_id=payload["story_id"], user_id=payload["user_id"],
                language=payload.get("language", "en"),
                version_id=payload.get("version_id", "v1"),
                story_type=rec["norm"]["story_type"],
                voice_id=payload.get("voice_id", ""),
                voice_name=rec["norm"]["voice_name"],
                bucket=payload.get("bucket"),
                update_firestore=rec["norm"]["update_firestore"])
            self.set_status(job_id, "done",
                            result=json.dumps(result, default=str))
        except Exception as e:  # noqa: BLE001 — worker must survive bad jobs
            logger.exception("job %s failed in finish", job_id)
            self.set_status(job_id, "error", error=str(e))
            self.client.xadd(DLQ_STREAM, {"source": self.stream,
                                          "job_id": job_id,
                                          "error": str(e)})
        self.client.xack(self.stream, self.group, mid)

    def run_continuous(self, *, stop_when_drained: bool = False) -> int:
        """Arrival-driven serving loop: TTS jobs stream through one
        persistent ContinuousStoryServer — a job that lands mid-decode joins
        the running engine at the next block boundary instead of waiting for
        a pool (6.5x mean / 36x p95 measured latency win at 80% load,
        PERF_NOTES.md q4aa). The per-job status/DLQ/storage contract is
        identical to run_once. `stop_when_drained` returns once the stream
        and the engine are empty (tests); production runs forever.
        Geometry knobs: WORKER_SLOTS, WORKER_TEXT_BUCKET, WORKER_BLOCK,
        WORKER_MAX_NEW_TOKENS."""
        from .continuous import ContinuousStoryServer
        srv = ContinuousStoryServer(
            self._get_tts(),
            slots=int(os.getenv("WORKER_SLOTS", "0")) or None,
            text_bucket=int(os.getenv("WORKER_TEXT_BUCKET", "256")),
            block=int(os.getenv("WORKER_BLOCK", "64")),
            max_new_tokens=int(os.getenv("WORKER_MAX_NEW_TOKENS", "1000")))
        live: Dict[int, Dict[str, Any]] = {}
        conds_cache: Dict[str, Any] = {}
        handled = 0
        pump_failures = 0
        while True:
            # poll without blocking while the engine has work; block briefly
            # when idle so an empty stream doesn't spin the host. NB: redis
            # treats BLOCK 0 as "block forever" — a non-blocking read must
            # OMIT the option (block=None), or an in-flight decode would
            # deadlock waiting for the next arrival
            block_ms = None if live else 2000
            msgs = self.client.xreadgroup(
                self.group, self.consumer, {self.stream: ">"},
                count=max(1, srv.srv.decoder.slots), block=block_ms)
            entries = [(mid, f) for _s, es in msgs or [] for mid, f in es]
            for mid, fields in entries:
                handled += self._continuous_intake(srv, live, conds_cache,
                                                   mid, fields)
            if live:
                try:
                    finished = srv.pump()
                    pump_failures = 0
                except Exception as e:  # noqa: BLE001 — jobs must not wedge
                    # transient device/tunnel failures: retry the pump (the
                    # server restores un-vocoded completions internally);
                    # persistent ones: fail every in-flight job VISIBLY
                    # (status + DLQ + ack) instead of leaving them stuck in
                    # "processing" forever, then surface to run_forever
                    pump_failures += 1
                    logger.exception("continuous pump failed (%d/3)",
                                     pump_failures)
                    if pump_failures < 3:
                        time.sleep(min(2.0 * pump_failures, 10.0))
                        continue
                    for jid, rec in list(live.items()):
                        job_id = rec["payload"].get("job_id", rec["mid"])
                        self.set_status(job_id, "error",
                                        error=f"continuous serving failed: {e}")
                        self.client.xadd(DLQ_STREAM,
                                         {"source": self.stream,
                                          "job_id": str(job_id),
                                          "error": str(e)})
                        self.client.xack(self.stream, self.group, rec["mid"])
                        live.pop(jid)
                    raise
                for jid, (wav, meta) in finished.items():
                    self._continuous_finish(live.pop(jid), wav, meta)
                    handled += 1
            elif stop_when_drained and not entries:
                return handled

    def run_forever(self):
        logger.info("worker %s consuming %s", self.consumer, self.stream)
        if self.mode == "tts" and self.continuous_enabled():
            logger.info("continuous serving enabled (slot-refill engine)")
            while True:
                try:
                    self.run_continuous()
                except KeyboardInterrupt:
                    break
                except Exception:  # noqa: BLE001
                    logger.exception("continuous loop error; backing off")
                    time.sleep(1.0)
            return
        while True:
            try:
                self.run_once()
            except KeyboardInterrupt:
                break
            except Exception:  # noqa: BLE001
                logger.exception("worker loop error; backing off")
                time.sleep(1.0)


def main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["tts", "vc"], default=os.getenv("WORKER_MODE", "tts"))
    args = ap.parse_args()
    RedisWorker(mode=args.mode).run_forever()


if __name__ == "__main__":
    main()
