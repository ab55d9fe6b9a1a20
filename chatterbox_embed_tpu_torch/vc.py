"""ChatterboxVC: voice conversion and profile-based TTS, the PyTorch
counterpart of `chatterbox_embed_tpu/vc.py` (set_target_voice / generate /
tts / inference_from_text / clean_audio / voice profiles), and the
voice-clone production pipeline (create_voice_clone, clone_voice, the
signed callback) over the port's serving/storage.py.

The models run on `device` (the card unless the caller names another): the
flow and vocoder with the compute `dtype`, the conditioning encoders
(CAMPPlus, S3 tokenizer, voice encoder) in fp32.
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
from scipy import signal as sp_signal

from .conditionals import Conditionals
from .config import S3_SR, S3GEN_SR, SPEECH_VOCAB_SIZE, ChatterboxConfig
from .device import resolve_device
from .models import layers as L
from .models import s3gen as s3gen_mod
from .models import s3tokenizer as s3tok_mod
from .models import t3 as t3_mod
from .models import voice_encoder as ve_mod
from .models.s3gen import VoiceProfile
from .models.t3 import T3Cond
from .models.tokenizer import EnTokenizer, FallbackTokenizer
from .ops.sampling import Draws
from .serving import storage
from .text import punc_norm
from .utils import audio_io
from .utils import weights as weights_mod
from .utils.watermark import get_watermarker
from .weights import FP32_S3GEN, convert_tree, place

logger = logging.getLogger(__name__)

_TOKEN_BUCKETS = (128, 256, 512, 1024)


def _bucket(n: int) -> int:
    for b in _TOKEN_BUCKETS:
        if n <= b:
            return b
    return n


class ChatterboxVC:
    def __init__(self, s3gen_params, t3_params=None, ve_params=None, tokenizer=None,
                 ref_dict: Optional[Dict[str, Any]] = None,
                 config: ChatterboxConfig = ChatterboxConfig(), dtype=torch.float32,
                 device=None):
        """The port's parameter trees (see weights.py), placed on `device`
        (None: the card). T3, the voice encoder and the tokenizer are
        optional: without them `generate` (conversion) still works, `tts`
        does not."""
        self.sr = S3GEN_SR
        self.cfg = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.s3gen_params = place(s3gen_params, self.device, dtype, fp32=FP32_S3GEN)
        self.t3_params = None if t3_params is None else place(t3_params, self.device, dtype)
        self.ve_params = (None if ve_params is None
                          else place(ve_params, self.device, torch.float32))
        self.tokenizer = tokenizer
        self.ref_dict = ref_dict
        self.ve_embedding: Optional[np.ndarray] = None
        self.watermarker = get_watermarker()
        # attachable raw-text -> speech-token encoder used by
        # inference_from_text: an object with `.encode(text)`, or a callable
        self.text_encoder = None

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    @classmethod
    def from_random(cls, seed: int = 0, config: ChatterboxConfig = ChatterboxConfig(),
                    dtype=torch.float32, device=None):
        """Randomly initialised models, drawn on `device` (None: the card)."""
        init = L.Init(seed, device)
        s3p = s3gen_mod.init(init, config.s3gen)
        t3p = t3_mod.init(init, config.t3)
        vep = ve_mod.init(init, config.voice_encoder)
        return cls(s3p, t3p, vep, FallbackTokenizer(config.t3), config=config, dtype=dtype,
                   device=init.device)

    @classmethod
    def from_pretrained(cls, device=None, **kw):
        """The reference checkpoints from the Hugging Face hub (tts.REPO_ID;
        the JAX package's from_pretrained), then from_local on their folder
        with `device` and `kw`. Raises RuntimeError when huggingface_hub
        cannot be imported."""
        from .tts import download_checkpoints
        return cls.from_local(download_checkpoints(), device=device, **kw)

    @classmethod
    def from_local(cls, ckpt_dir, config: ChatterboxConfig = ChatterboxConfig(),
                   dtype=torch.float32, device=None):
        """Load reference checkpoints from `ckpt_dir`: s3gen.safetensors, and
        when present t3_cfg.safetensors, ve.safetensors, tokenizer.json and
        conds.pt (whose S3Gen half becomes the target voice)."""
        ckpt_dir = Path(ckpt_dir)
        device = resolve_device(device)
        meta = L.Init(device="meta")

        def tree(init_fn, cfg, arrays, name):
            return convert_tree(init_fn(meta, cfg), arrays, name, relayout=False)

        s3gen_params = tree(s3gen_mod.init, config.s3gen, weights_mod.convert_s3gen(
            weights_mod.load_safetensors(str(ckpt_dir / "s3gen.safetensors")),
            cfg=config.s3gen), "S3Gen")
        t3_params = ve_params = tokenizer = None
        if (ckpt_dir / "t3_cfg.safetensors").exists():
            t3_params = tree(t3_mod.init, config.t3, weights_mod.convert_t3(
                weights_mod.load_safetensors(str(ckpt_dir / "t3_cfg.safetensors")),
                num_layers=config.t3.llama.num_layers), "T3")
        if (ckpt_dir / "ve.safetensors").exists():
            ve_params = tree(ve_mod.init, config.voice_encoder, weights_mod.convert_voice_encoder(
                weights_mod.load_safetensors(str(ckpt_dir / "ve.safetensors"))), "VoiceEncoder")
        if (ckpt_dir / "tokenizer.json").exists():
            tokenizer = EnTokenizer(str(ckpt_dir / "tokenizer.json"))
        ref_dict = None
        if (ckpt_dir / "conds.pt").exists():
            ref_dict = Conditionals.load(str(ckpt_dir / "conds.pt"), device=device).gen
        return cls(s3gen_params, t3_params, ve_params, tokenizer, ref_dict, config, dtype,
                   device)

    # ------------------------------------------------------------------
    # target voice
    # ------------------------------------------------------------------

    def _ve_embedding_of(self, path: str) -> np.ndarray:
        wav16, _ = audio_io.load_audio(path, sr=S3_SR, device=self.device)
        return ve_mod.embeds_from_wavs(self.ve_params, [wav16], S3_SR, self.cfg.voice_encoder
                                       ).mean(axis=0, keepdims=True)

    def set_target_voice(self, wav_fpath: str):
        wav, sr = audio_io.load_audio(wav_fpath)
        self.ref_dict = s3gen_mod.embed_ref(self.s3gen_params, wav, sr, self.cfg.s3gen)
        if self.ve_params is not None:
            self.ve_embedding = self._ve_embedding_of(wav_fpath)

    # ------------------------------------------------------------------
    # voice conversion
    # ------------------------------------------------------------------

    def generate(self, audio, target_voice_path: Optional[str] = None, seed: int = 0,
                 draws=None) -> np.ndarray:
        """Convert `audio` (a path, or a 16 kHz waveform) to the target
        voice. Returns (1, T) float32 at 24 kHz, T = 2 * tokens * 480.

        draws: optional draw source for the vocoder's phases and noise
        (`Draws(seed, device)` by default)."""
        if target_voice_path:
            self.set_target_voice(target_voice_path)
        if self.ref_dict is None:
            raise RuntimeError("no target voice set")
        if isinstance(audio, str):
            wav16, _ = audio_io.load_audio(audio, sr=S3_SR, device=self.device)
        else:
            wav16 = np.asarray(audio, np.float32).reshape(-1)
        wav16 = s3tok_mod.pad_to_token_multiple(wav16)
        tokens, _lens = s3tok_mod.tokenize_wave(
            self.s3gen_params["tokenizer"], torch.from_numpy(wav16)[None].to(self.device),
            cfg=self.cfg.s3gen.tokenizer)
        wav = self._tokens_to_wav(tokens[0].cpu().numpy(), seed, draws)
        wav = self.watermarker.apply_watermark(wav, sample_rate=self.sr)
        return wav[None, :]

    def _tokens_to_wav(self, speech_tokens: np.ndarray, seed: int = 0, draws=None) -> np.ndarray:
        gen = self.ref_dict
        dev = self.device
        n = int(speech_tokens.shape[-1])
        toks = np.zeros((1, _bucket(n)), np.int64)
        toks[0, :n] = speech_tokens
        prompt_len = int(np.asarray(gen["prompt_token_len"]).reshape(-1)[0])
        wav = s3gen_mod.token_to_wav(
            self.s3gen_params, torch.from_numpy(toks).to(dev),
            torch.tensor([prompt_len + n], device=dev),
            torch.as_tensor(np.asarray(gen["prompt_token"]), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(gen["prompt_feat"]), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(gen["embedding"]), dtype=torch.float32, device=dev),
            draws if draws is not None else Draws(seed, dev),
            cfg=self.cfg.s3gen, dtype=self.dtype)
        return wav[0, : 2 * n * 480].float().cpu().numpy()

    def inference_from_text(self, text: str, ref_dict: Dict[str, Any], *,
                            finalize: bool = True, seed: int = 0, draws=None) -> np.ndarray:
        """Raw text + in-memory voice profile -> waveform, through an
        attached `text_encoder` with `encode(text) -> speech token ids` (or a
        bare callable). Raises RuntimeError when no encoder is attached, so
        that callers can fall back. Returns (T,) float32 at 24 kHz."""
        if self.text_encoder is None:
            raise RuntimeError(
                "ChatterboxVC.inference_from_text: no `text_encoder` attached "
                "(expected an object with `.encode(text) -> token ids`).")
        if hasattr(self.text_encoder, "encode"):
            speech_tokens = self.text_encoder.encode(text)
        elif callable(self.text_encoder):
            speech_tokens = self.text_encoder(text)
        else:
            raise RuntimeError(
                "ChatterboxVC.inference_from_text: `text_encoder` has neither "
                f"an `.encode()` method nor is callable (got {type(self.text_encoder)})")
        speech_tokens = np.asarray(speech_tokens, np.int32).reshape(-1)
        speech_tokens = speech_tokens[speech_tokens < SPEECH_VOCAB_SIZE]
        prev = self.ref_dict
        try:
            self.ref_dict = ref_dict
            return self._tokens_to_wav(speech_tokens, seed, draws)
        finally:
            self.ref_dict = prev

    # ------------------------------------------------------------------
    # profile-based TTS
    # ------------------------------------------------------------------

    def tts(self, text: str, voice_profile_path: Optional[str] = None,
            temperature: float = 0.8, cfg_weight: float = 0.5, exaggeration: float = 0.5,
            seed: int = 0, draws=None) -> np.ndarray:
        """Text to speech in the set voice (or `voice_profile_path`'s):
        T3, S3Gen, watermark, peak-normalised to -1 dBFS. Returns (1, T)."""
        if self.t3_params is None or self.tokenizer is None:
            raise RuntimeError("the tts path needs T3 and a tokenizer")
        profile = None
        if voice_profile_path:
            profile = self.set_voice_profile(voice_profile_path)
        if self.ref_dict is None:
            raise RuntimeError("no voice profile / target voice set")

        text = punc_norm(text)
        tok = self.tokenizer.text_to_tokens(text)[0]
        t3cfg = self.cfg.t3
        text_tokens = np.concatenate([[t3cfg.start_text_token], tok,
                                      [t3cfg.stop_text_token]]).astype(np.int32)[None]
        spk = self.ve_embedding
        if spk is None and profile is not None and profile.ve_embedding is not None:
            spk = np.asarray(profile.ve_embedding)
        if spk is None:
            raise RuntimeError("profile missing ve_embedding")
        plen = t3cfg.speech_cond_prompt_len
        dev = self.device
        cond = T3Cond(
            speaker_emb=torch.as_tensor(np.asarray(spk), dtype=torch.float32, device=dev),
            cond_prompt_speech_tokens=torch.as_tensor(
                np.asarray(self.ref_dict["prompt_token"])[:, :plen], dtype=torch.int32,
                device=dev),
            emotion_adv=float(exaggeration))
        speech = t3_mod.generate(self.t3_params, cond, text_tokens, max_new_tokens=1000,
                                 temperature=temperature, cfg_weight=cfg_weight, seed=seed,
                                 draws=draws, cfg=t3cfg, dtype=self.dtype, device=dev)
        speech = s3gen_mod.drop_invalid_tokens(s3tok_mod.drop_invalid_tokens(speech))
        wav = self._tokens_to_wav(speech, seed, draws)
        wav = self.watermarker.apply_watermark(wav, sample_rate=self.sr)
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / peak * 10 ** (-1.0 / 20.0)
        return wav[None, :]

    # ------------------------------------------------------------------
    # audio cleaning (host-side numpy / scipy)
    # ------------------------------------------------------------------

    def clean_audio(self, in_path: str, out_path: Optional[str] = None) -> str:
        """Spectral-gate denoise, 85 Hz 6th-order high-pass, -3 dB peak
        norm, edge trims. The gate is non-stationary by default (a
        time-smoothed per-frequency noise floor); CHATTERBOX_CLEAN_STATIONARY=1
        switches to the stationary gate."""
        wav, sr = audio_io.load_audio(in_path)
        if os.getenv("CHATTERBOX_CLEAN_STATIONARY", "0") == "1":
            wav = _spectral_gate(wav, sr)
        else:
            wav = _spectral_gate_nonstationary(wav, sr)
        sos = sp_signal.butter(6, 85.0, btype="highpass", fs=sr, output="sos")
        wav = sp_signal.sosfilt(sos, wav).astype(np.float32)
        peak = np.abs(wav).max()
        if peak > 0:
            wav = wav / peak * 10 ** (-3.0 / 20.0)
        wav = ve_mod.trim_silence(wav, top_db=30)
        wav = ve_mod.trim_silence(wav, top_db=40)
        out_path = out_path or in_path.rsplit(".", 1)[0] + "_clean.wav"
        audio_io.save_audio(out_path, wav, sr)
        return out_path

    # ------------------------------------------------------------------
    # voice profiles
    # ------------------------------------------------------------------

    def save_voice_profile(self, audio_file_path: str, save_path: str):
        wav, sr = audio_io.load_audio(audio_file_path)
        rd = s3gen_mod.embed_ref(self.s3gen_params, wav, sr, self.cfg.s3gen)
        ve_embedding = None
        if self.ve_params is not None:
            ve_embedding = self._ve_embedding_of(audio_file_path).astype(np.float32)
        VoiceProfile(embedding=rd["embedding"], prompt_feat=rd["prompt_feat"],
                     prompt_feat_len=rd["prompt_feat_len"], prompt_token=rd["prompt_token"],
                     prompt_token_len=rd["prompt_token_len"],
                     ve_embedding=ve_embedding).save(save_path)

    def load_voice_profile(self, path: str) -> VoiceProfile:
        return VoiceProfile.load(path)

    def set_voice_profile(self, path: str) -> VoiceProfile:
        profile = VoiceProfile.load(path)
        self.ref_dict = dict(prompt_token=profile.prompt_token,
                             prompt_token_len=profile.prompt_token_len,
                             prompt_feat=profile.prompt_feat,
                             prompt_feat_len=profile.prompt_feat_len,
                             embedding=profile.embedding)
        if profile.ve_embedding is not None:
            self.ve_embedding = np.asarray(profile.ve_embedding)
        return profile


    # ------------------------------------------------------------------
    # clone pipeline (reference: vc.py:817-1244)
    # ------------------------------------------------------------------

    def create_voice_clone(self, audio_path: str, voice_id: str, voice_name: str = "",
                           user_id: str = "", language: str = "en",
                           bucket: Optional[str] = None,
                           callback_url: Optional[str] = None,
                           sample_text: Optional[str] = None,
                           metadata: Optional[Dict[str, Any]] = None,
                           is_kids_voice: bool = False) -> Dict[str, Any]:
        """clean -> save profile -> set -> TTS sample -> MP3 -> upload ->
        Firestore upsert -> HMAC callback (reference: vc.py:817-1244).

        `metadata` follows the reference contract: may carry language,
        is_kids_voice, callback_url, storage_metadata (user_id/voice_name),
        model_type and explicit profile_filename / sample_filename /
        recorded_path; when filenames are present the reference's
        `audio/voices/{language}[/kids]/...` storage layout is used.
        BOTH outcomes fire the signed callback: success payloads and error
        payloads (status, error) — the round-1 build only signed success.
        """
        t0 = time.time()
        metadata = metadata or {}
        language = metadata.get("language", language)
        is_kids_voice = bool(metadata.get("is_kids_voice", is_kids_voice))
        callback_url = metadata.get("callback_url", callback_url)
        storage_meta = metadata.get("storage_metadata") or {}
        user_id = storage_meta.get("user_id", user_id)
        voice_name = storage_meta.get("voice_name", voice_name)
        model_type = metadata.get("model_type", "chatterbox")
        base_path = (f"audio/voices/{language}/kids" if is_kids_voice
                     else f"audio/voices/{language}")
        profile_fn = metadata.get("profile_filename")
        sample_fn = metadata.get("sample_filename")
        recorded_path = (metadata.get("recorded_path")
                         or metadata.get("recorded_filename") or "")
        profile_key = (f"{base_path}/profiles/{profile_fn}" if profile_fn
                       else f"private/users/{user_id}/voices/profiles/{voice_id}.npy")
        sample_key = (f"{base_path}/samples/{sample_fn}" if sample_fn
                      else f"private/users/{user_id}/voices/samples/{voice_id}.mp3")

        def cb_payload(status: str, **extra) -> Dict[str, Any]:
            p = {"status": status, "user_id": user_id, "voice_id": voice_id,
                 "voice_name": voice_name, "language": language,
                 "is_kids_voice": is_kids_voice, "model_type": model_type,
                 "profile_path": profile_key, "sample_path": sample_key,
                 "recorded_path": recorded_path}
            p.update(extra)
            return p

        clean_path = profile_path = None
        result: Dict[str, Any] = {"voice_id": voice_id, "voice_name": voice_name}
        try:
            clean_path = self.clean_audio(audio_path)
            with tempfile.NamedTemporaryFile(suffix=".npy", delete=False) as f:
                profile_path = f.name
            self.save_voice_profile(clean_path, profile_path)
            self.set_voice_profile(profile_path)

            # profile upload
            with open(profile_path, "rb") as fh:
                profile_bytes = fh.read()
            result["profile_url"] = storage.upload_to_r2(
                profile_bytes, profile_key, bucket)
            result["profile_key"] = profile_key

            # sample synthesis; without a T3 path (no T3, tokenizer or speaker
            # embedding) the cleaned reference audio itself (reference:
            # vc.py:926-939). The JAX package also takes the reference audio
            # when the synthesis raises; here a failed kernel propagates.
            sample_text = sample_text or "Hello! This is a preview of your cloned voice."
            if (self.t3_params is not None and self.tokenizer is not None
                    and self.ve_embedding is not None):
                sample_wav = self.tts(sample_text).reshape(-1)
            else:
                logger.warning("no T3 path for the sample; using reference audio")
                sample_wav, _ = audio_io.load_audio(clean_path, sr=self.sr,
                                                     device=self.device)
            mp3 = audio_io.wav_to_mp3_bytes(sample_wav, self.sr)
            result["sample_url"] = storage.upload_to_r2(mp3, sample_key, bucket,
                                                        content_type="audio/mpeg")
            result["sample_key"] = sample_key

            # Firestore upsert (reference: vc.py voice_profiles/{voice_id})
            try:
                client = storage.init_firestore_client()
                client.collection("voice_profiles").document(voice_id).set({
                    "voice_id": voice_id, "name": voice_name, "user_id": user_id,
                    "language": language, "profile_key": profile_key,
                    "sample_key": sample_key, "created_at": time.time(),
                }, merge=True)
                result["firestore_updated"] = True
            except Exception as e:  # noqa: BLE001
                logger.warning("firestore upsert failed: %s", e)
                result["firestore_updated"] = False

            result["status"] = "success"
            result["elapsed_s"] = time.time() - t0
            if callback_url:
                _signed_callback(callback_url, cb_payload("success"))
            return result
        except Exception as e:  # noqa: BLE001
            # error-path callback (reference: vc.py:1177-1237)
            logger.error("create_voice_clone failed: %s", e)
            if callback_url:
                try:
                    _signed_callback(callback_url, cb_payload("error", error=str(e)))
                except Exception as cb_e:  # noqa: BLE001
                    logger.warning("error callback failed: %s", cb_e)
            return {"status": "error", "voice_id": voice_id, "error": str(e),
                    "generation_time": time.time() - t0}
        finally:
            for p in (profile_path, clean_path):
                if p is None:
                    continue
                try:
                    os.unlink(p)
                except OSError:
                    pass


def _signed_callback(url: str, payload: Dict[str, Any]):
    """HMAC-SHA256 signed POST using the reference wire protocol
    (reference: vc.py:1147-1166): signature over "POST\\n{path}\\n{ts}\\n"+body
    in X-Minstraly-Signature with X-Minstraly-Timestamp; unsigned when no
    shared secret is configured."""
    import urllib.request
    from urllib.parse import urlparse
    secret = os.getenv("MINSTRALY_API_SHARED_SECRET", "")
    body = json.dumps(payload, default=str).encode()
    headers = {"Content-Type": "application/json"}
    if secret:
        path = urlparse(url).path or "/api/voice-clone/callback"
        ts = str(int(time.time() * 1000))
        prefix = f"POST\n{path}\n{ts}\n".encode()
        sig = hmac.new(secret.encode(), prefix + body, hashlib.sha256).hexdigest()
        headers.update({"X-Minstraly-Timestamp": ts, "X-Minstraly-Signature": sig})
    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    try:
        urllib.request.urlopen(req, timeout=15)
    except Exception as e:  # noqa: BLE001
        logger.warning("callback to %s failed: %s", url, e)


def clone_voice(vc: ChatterboxVC, *, voice_id: str, voice_name: str = "",
                user_id: str = "", language: str = "en",
                audio_b64: Optional[str] = None, audio_r2_key: Optional[str] = None,
                bucket: Optional[str] = None,
                metadata: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Worker entry: bytes -> temp file -> create_voice_clone
    (reference: vc.py:1284-1364; the reference's worker passes an unsupported
    `profile_id` kwarg — a live bug we do not replicate)."""
    if audio_b64:
        data = base64.b64decode(audio_b64)
    elif audio_r2_key:
        data = storage.download_from_r2(audio_r2_key, bucket)
    else:
        raise ValueError("need audio_b64 or audio_r2_key")
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        f.write(data)
        path = f.name
    try:
        return vc.create_voice_clone(path, voice_id, voice_name, user_id, language,
                                     bucket, metadata=metadata)
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def _spectral_gate_nonstationary(wav: np.ndarray, sr: int, n_fft: int = 1024,
                                 prop_decrease: float = 0.85,
                                 time_constant_s: float = 2.0,
                                 thresh_mult: float = 2.0,
                                 slope: float = 10.0) -> np.ndarray:
    """Non-stationary spectral gating in the manner of `noisereduce`: the
    noise floor is a per-frequency time-smoothed magnitude (a window of
    time_constant_s), so slowly varying background is tracked; bins are
    soft-masked by a sigmoid on their relative excess over the floor."""
    hop = n_fft // 4
    if len(wav) < n_fft:
        return wav
    from scipy.ndimage import uniform_filter1d
    f, t, z = sp_signal.stft(wav, fs=sr, nperseg=n_fft, noverlap=n_fft - hop)
    mag = np.abs(z)
    frames = max(1, int(time_constant_s * sr / hop))
    floor = uniform_filter1d(mag, frames, axis=1, mode="nearest")
    excess = (mag - floor) / (floor + 1e-12)
    mask = 1.0 / (1.0 + np.exp(-(excess - thresh_mult) * slope))
    # smooth the mask over time so note onsets don't flutter
    mask = uniform_filter1d(mask, 5, axis=1, mode="nearest")
    # passed bins ~1, gated bins (1 - prop_decrease)
    gain = mask * prop_decrease + (1.0 - prop_decrease)
    _, clean = sp_signal.istft(z * gain, fs=sr, nperseg=n_fft, noverlap=n_fft - hop)
    return clean[: len(wav)].astype(np.float32)


def _spectral_gate(wav: np.ndarray, sr: int, n_fft: int = 1024,
                   prop_decrease: float = 1.0) -> np.ndarray:
    """Stationary spectral gating: the noise floor per frequency from the
    quietest frames; bins below floor + 1.5 std are masked."""
    hop = n_fft // 4
    if len(wav) < n_fft:
        return wav
    f, t, z = sp_signal.stft(wav, fs=sr, nperseg=n_fft, noverlap=n_fft - hop)
    mag = np.abs(z)
    db = 20.0 * np.log10(mag + 1e-10)
    frame_energy = db.mean(axis=0)
    quiet = db[:, frame_energy <= np.quantile(frame_energy, 0.1)]
    if quiet.size == 0:
        return wav
    noise_mean = quiet.mean(axis=1, keepdims=True)
    noise_std = quiet.std(axis=1, keepdims=True)
    thresh = noise_mean + 1.5 * noise_std
    mask = (db > thresh).astype(np.float32)
    # smooth the mask over time
    kernel = np.ones((1, 5), np.float32) / 5.0
    mask = sp_signal.convolve2d(mask, kernel, mode="same")
    gain = mask + (1.0 - mask) * (1.0 - prop_decrease)
    _, clean = sp_signal.istft(z * gain, fs=sr, nperseg=n_fft, noverlap=n_fft - hop)
    return clean[: len(wav)].astype(np.float32)
