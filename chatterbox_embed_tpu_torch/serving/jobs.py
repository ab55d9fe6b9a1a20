"""End-to-end serving jobs, the port's own copy of
`chatterbox_embed_tpu/serving/jobs.py` (reference: tts.py:1520-1799
generate_tts_story — profile from base64 or R2, long-text synthesis, MP3 encode, R2 upload at the
production path layout, optional direct Firestore status update).

Beyond the reference: `generate_tts_stories_batch` pools several jobs into
one multi-voice lock-step decode (dynamic batching; the reference runs one
job per accelerator at a time) while keeping each job's storage/status
contract identical to the single-job path."""
from __future__ import annotations

import base64
import logging
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..utils import audio_io
from . import storage

logger = logging.getLogger(__name__)


def _fetch_profile(voice_profile_b64: Optional[str],
                   voice_profile_r2_key: Optional[str],
                   bucket: Optional[str]) -> str:
    """Materialise the job's voice profile to a temp .npy path
    (reference: tts.py:1545-1600). Caller unlinks."""
    with tempfile.NamedTemporaryFile(suffix=".npy", delete=False) as f:
        profile_path = f.name
    try:
        if voice_profile_b64:
            with open(profile_path, "wb") as fh:
                fh.write(base64.b64decode(voice_profile_b64))
        elif voice_profile_r2_key:
            with open(profile_path, "wb") as fh:
                fh.write(storage.download_from_r2(voice_profile_r2_key, bucket))
        else:
            raise ValueError("need voice_profile_b64 or voice_profile_r2_key")
    except Exception:
        try:
            os.unlink(profile_path)
        except OSError:
            pass
        raise
    return profile_path


def _normalize_story_fields(story_type: str, voice_name: str, voice_id: str,
                            metadata: Optional[Dict[str, Any]],
                            update_firestore: Optional[bool]):
    metadata = metadata or {}
    voice_name = voice_name or metadata.get("voice_name") or voice_id
    story_type = metadata.get("story_type", story_type)
    if story_type not in ("user", "app"):
        logger.warning("invalid story_type %r, defaulting to 'user'", story_type)
        story_type = "user"
    if update_firestore is None:
        update_firestore = os.getenv(
            "CHATTERBOX_ENABLE_DIRECT_FIRESTORE_UPDATE", "false").lower() == "true"
    return story_type, voice_name, metadata, update_firestore


def _finish_story_job(tts, wav: np.ndarray, gen_metadata: Dict[str, Any],
                      t0: float, *, story_id: str, user_id: str,
                      language: str, version_id: str, story_type: str,
                      voice_id: str, voice_name: str, bucket: Optional[str],
                      update_firestore: bool) -> Dict[str, Any]:
    """MP3 encode + R2 upload + result payload + optional Firestore update
    (reference: tts.py:1690-1789). The result dict carries the reference's
    payload fields plus this rebuild's richer metadata."""
    mp3 = audio_io.wav_to_mp3_bytes(wav.reshape(-1), tts.sr, bitrate="96k")
    audio_key = (f"private/users/{user_id}/stories/audio/{language}/"
                 f"{story_id}/{version_id}.mp3")
    url = storage.upload_to_r2(mp3, audio_key, bucket, content_type="audio/mpeg",
                               metadata={"story_id": story_id, "user_id": user_id})

    duration = gen_metadata.get("duration_s", 0)
    result = {
        "status": "success",
        "audio_data": base64.b64encode(mp3).decode("ascii"),
        "storage_url": url,
        "storage_path": audio_key,
        "r2_path": audio_key,
        "r2_url": url,
        "audio_url": url,
        "firebase_url": url,      # compatibility aliases (reference keeps both)
        "firebase_path": audio_key,
        "version_id": version_id,
        "story_type": story_type,
        "generation_time": time.time() - t0,
        "duration": duration,
        # rebuild extras (supersets, not replacements)
        "story_id": story_id,
        "user_id": user_id,
        "audio_key": audio_key,
        "duration_s": duration,
        "generation_time_s": time.time() - t0,
        "metadata": gen_metadata,
    }
    if update_firestore:
        try:
            client = storage.init_firestore_client()
            doc = client.collection("stories").document(story_id)
            new_version = {
                "id": version_id, "voiceId": voice_id, "voiceName": voice_name,
                "audioUrl": url, "url": url, "service": "chatterbox",
                "createdAt": time.time(), "updatedAt": time.time(),
                "metadata": {"format": "mp3", "size": len(mp3),
                             "duration": duration, "voiceName": voice_name,
                             "r2Path": audio_key},
            }
            doc.set({"audioStatus": "ready", "audioUrl": url,
                     "updatedAt": time.time()}, merge=True)
            try:
                snap = doc.get()
                existing = []
                if snap.exists and isinstance(snap.to_dict().get("audioVersions"),
                                              list):
                    existing = snap.to_dict()["audioVersions"]
                doc.set({"audioVersions": existing + [new_version]}, merge=True)
            except Exception:  # noqa: BLE001
                doc.set({"audioVersions": [new_version]}, merge=True)
            result["firestore_updated"] = True
            result["firestore_story_id"] = story_id
        except Exception as e:  # noqa: BLE001 — job must not die on status write
            logger.warning("firestore update failed: %s", e)
            result["firestore_updated"] = False
    return result


def generate_tts_story(tts, *, story_id: str, user_id: str, text: str,
                       voice_profile_b64: Optional[str] = None,
                       voice_profile_r2_key: Optional[str] = None,
                       language: str = "en", version_id: str = "v1",
                       exaggeration: float = 0.5, cfg_weight: float = 0.6,
                       temperature: float = 0.7, bucket: Optional[str] = None,
                       update_firestore: Optional[bool] = None,
                       voice_id: str = "", voice_name: str = "",
                       story_type: str = "user", is_kids_voice: bool = False,
                       pause_scale: float = 1.15,
                       metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Full TTS job. The result dict carries the reference's payload fields
    (status, audio_data, storage_url/storage_path, r2_path/r2_url, audio_url,
    firebase_url/firebase_path aliases, version_id, story_type,
    generation_time, duration — reference tts.py:1711-1726) plus this
    rebuild's richer metadata; the error path mirrors tts.py:1790-1799."""
    t0 = time.time()
    story_type, voice_name, metadata, update_firestore = _normalize_story_fields(
        story_type, voice_name, voice_id, metadata, update_firestore)

    try:
        # --- voice profile: base64 payload or R2 object (reference: tts.py:1545-1600)
        profile_path = _fetch_profile(voice_profile_b64, voice_profile_r2_key,
                                      bucket)
        try:
            prev_pause = tts.advanced_stitcher.global_pause_factor
            tts.advanced_stitcher.global_pause_factor = pause_scale
            try:
                wav, gen_metadata = tts.generate_long_text(
                    text, voice_profile_path=profile_path, exaggeration=exaggeration,
                    cfg_weight=cfg_weight, temperature=temperature)
            finally:
                tts.advanced_stitcher.global_pause_factor = prev_pause
        finally:
            try:
                os.unlink(profile_path)
            except OSError:
                pass

        return _finish_story_job(
            tts, wav, gen_metadata, t0, story_id=story_id, user_id=user_id,
            language=language, version_id=version_id, story_type=story_type,
            voice_id=voice_id, voice_name=voice_name, bucket=bucket,
            update_firestore=update_firestore)
    except Exception as e:  # noqa: BLE001 (reference: tts.py:1790-1799)
        logger.error("generate_tts_story failed: %s", e)
        return {"status": "error", "error": str(e),
                "generation_time": time.time() - t0}


def generate_tts_stories_batch(tts, payloads: List[Dict[str, Any]],
                               bucket: Optional[str] = None) -> List[Dict[str, Any]]:
    """MANY TTS jobs in one pooled decode (dynamic serving batches).

    Every job's text is chunked; all chunks across all jobs run as one
    multi-voice lock-step batch (`tts.generate_long_text_batch`, per-row
    conds + per-row sampling params, transparent sub-batching at the HBM
    fence); stitching, watermarking, MP3 encode, R2 upload, and the result
    payload stay per job and byte-compatible with `generate_tts_story`.
    A failing job yields its own error result and never kills the batch.
    """
    t0 = time.time()
    n = len(payloads)
    results: List[Optional[Dict[str, Any]]] = [None] * n
    norm: List[Optional[Dict[str, Any]]] = [None] * n
    profile_paths: List[Optional[str]] = [None] * n
    # profiles with identical bytes share one temp file (and therefore one
    # Conditionals prep) — batches from the same voice are common
    profile_dedupe: Dict[Tuple[Optional[str], Optional[str], Optional[str]],
                         str] = {}
    live: List[int] = []
    try:
        for i, p in enumerate(payloads):
            try:
                missing = [k for k in ("text", "story_id", "user_id") if k not in p]
                if missing:
                    raise ValueError(f"missing required fields: {missing}")
                story_type, voice_name, metadata, update_fs = \
                    _normalize_story_fields(p.get("story_type", "user"),
                                            p.get("voice_name", ""),
                                            p.get("voice_id", ""),
                                            p.get("metadata"),
                                            p.get("update_firestore"))
                # the bucket is part of an R2 key's identity — two jobs with
                # the same key in different buckets are DIFFERENT voices
                # (inline b64 bytes are bucket-independent)
                key = (p.get("voice_profile_b64"), p.get("voice_profile_r2_key"),
                       p.get("bucket", bucket)
                       if p.get("voice_profile_r2_key") else None)
                if key not in profile_dedupe:
                    profile_dedupe[key] = _fetch_profile(key[0], key[1],
                                                         p.get("bucket", bucket))
                profile_paths[i] = profile_dedupe[key]
                norm[i] = dict(story_type=story_type, voice_name=voice_name,
                               metadata=metadata, update_firestore=update_fs)
                live.append(i)
            except Exception as e:  # noqa: BLE001 — isolate bad jobs
                logger.error("batch job %d failed in setup: %s", i, e)
                results[i] = {"status": "error", "error": str(e),
                              "generation_time": time.time() - t0}

        gen = tts.generate_long_text_batch(
            [payloads[i]["text"] for i in live],
            voice_profile_paths=[profile_paths[i] for i in live],
            exaggeration=[float(payloads[i].get("exaggeration", 0.5)) for i in live],
            cfg_weight=[float(payloads[i].get("cfg_weight", 0.6)) for i in live],
            temperature=[float(payloads[i].get("temperature", 0.7)) for i in live],
            pause_scales=[float(payloads[i].get("pause_scale", 1.15)) for i in live],
        ) if live else []
    finally:
        for path in profile_dedupe.values():
            try:
                os.unlink(path)
            except OSError:
                pass

    for k, i in enumerate(live):
        p = payloads[i]
        wav, gen_metadata = gen[k]
        if wav is None:
            logger.error("batch job %d failed in generation: %s", i,
                         gen_metadata.get("error"))
            results[i] = {"status": "error",
                          "error": str(gen_metadata.get("error", "generation failed")),
                          "generation_time": time.time() - t0}
            continue
        try:
            results[i] = _finish_story_job(
                tts, wav, gen_metadata, t0,
                story_id=p["story_id"], user_id=p["user_id"],
                language=p.get("language", "en"),
                version_id=p.get("version_id", "v1"),
                story_type=norm[i]["story_type"],
                voice_id=p.get("voice_id", ""),
                voice_name=norm[i]["voice_name"],
                bucket=p.get("bucket", bucket),
                update_firestore=norm[i]["update_firestore"])
        except Exception as e:  # noqa: BLE001 — isolate bad jobs
            logger.exception("batch job %d failed in upload", i)
            results[i] = {"status": "error", "error": str(e),
                          "generation_time": time.time() - t0}
    return results  # every entry filled by one of the paths above
