"""ChatterboxTTS, the public text-to-speech pipeline: the PyTorch counterpart
of `chatterbox_embed_tpu/tts.py`: one utterance (`generate`: tokenize, T3,
S3Gen), streamed (`stream_generate`: audio chunks as the tokens decode) or a
batch of them (`generate_batch`: one lock-step T3 decode, then S3Gen in
sub-batches), with one voice or one voice per utterance, and long text
(`generate_long_text`, `generate_long_text_batch`: sanitise, chunk, one
pooled `generate_batch` over every chunk, the retry pyramid for chunks that
fail a gate, stitch, watermark).

CHATTERBOX_ALIGNMENT=1 (read at call time) decodes under the alignment
guard (models/t3.py); CHATTERBOX_CONTINUOUS=1 runs the long-text pooled
pass on the slot-refill engine (serving/continuous.py). The long-text path
catches only what the JAX package's catches are there for: the token
guard's TokenGuardError (retry), a batch of voices generate_batch cannot
pool (VoiceBatchError: the chunks run one by one), a chunk the engine
refuses at submit (the lock-step batch serves) and a bad job's text or
voice file (per-job isolation). CUDA and kernel errors propagate.

Serving jobs (`generate_tts_story`, `upload_to_storage`) go through
serving/jobs.py and serving/storage.py.

The voice comes from prepared conditionals, or is prepared from reference
audio (`prepare_conditionals_with_audio_prompt`: prompt mel, CAMPPlus
x-vector, S3 prompt tokens, voice-encoder embedding), from a saved voice
profile (`.npy`) or from a saved x-vector plus prompt audio; the last
preparation is cached by its key.

Host code tokenizes, pads to buckets and moves numpy at the edges; T3,
S3Gen and the conditioning encoders run on `device` (the card unless the
caller names another), T3 and S3Gen with the compute `dtype`, the
conditioning encoders in fp32.

`enable_mesh` serves T3 on a dp x tp mesh (parallel/): `generate`,
`generate_batch`, long text and the continuous engine decode over it, while
S3Gen, the conditioning and `stream_generate` stay on this process's card.

int8, read where the JAX package reads it: `from_local(int8=True)` or
CHATTERBOX_INT8=1 quantises T3's backbone linears after conversion,
CHATTERBOX_INT8_S3GEN=1 the flow stack's (utils/quantize.py); each linear
is dequantised before its matmul. CHATTERBOX_INT8_KV=1 keeps the KV cache in
int8 (models/llama.py; read at each generation and engine). On a GPU every
default is no int8; the JAX package's defaults of int8 weights and cache
are a TPU's. An int8 backbone never takes the fused step (K4 streams a bf16
wall), and the int8 cache yields to K4 where K4 serves.
"""
from __future__ import annotations

import logging
import os
import tempfile
import time
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import streaming
from .chunking import ChunkInfo, SmartChunker
from .conditionals import Conditionals
from .config import S3_SR, S3GEN_SR, SPEECH_VOCAB_SIZE, ChatterboxConfig
from .device import lap, resolve_device
from .models import layers as L
from .models import s3gen as s3gen_mod
from .models import s3tokenizer as s3tok_mod
from .models import t3 as t3_mod
from .models import voice_encoder as ve_mod
from .models.s3gen import VoiceProfile
from .models.t3 import T3Cond
from .models.tokenizer import EnTokenizer, FallbackTokenizer
from .ops.sampling import Draws
from .parameters import AdaptiveParameterManager
from .quality import ChunkQualityAnalyzer
from .stitching import AdvancedStitcher
from .text import STORY_BREAK_TOKEN, AdvancedTextSanitizer
from .utils import audio_io, profiling
from .utils import weights as weights_mod
from .utils.watermark import get_watermarker
from .weights import FP32_S3GEN, from_arrays, place

logger = logging.getLogger(__name__)

CHATTERBOX_RUNTIME_VERSION = "torch-0.1.0"
# the Hugging Face repository of the reference checkpoints (from_pretrained)
REPO_ID = "ResembleAI/chatterbox"
CHECKPOINT_FILES = ("ve.safetensors", "t3_cfg.safetensors", "s3gen.safetensors",
                    "tokenizer.json", "conds.pt")
_TOKEN_BUCKETS = (128, 256, 512, 1024)
# what a long-text job's own text or voice file may raise before generation;
# generate_long_text_batch records it as that job's error
_JOB_ERRORS = (ValueError, OSError, KeyError)


class TokenGuardError(RuntimeError):
    """T3 gave no or too few speech tokens (`_guard_tokens`). The long-text
    retry pyramid retries on this error and on nothing else."""


class VoiceBatchError(ValueError):
    """generate_batch cannot hold these voices in one lock-step batch (the
    JAX package's multi-voice asserts); the long-text path then runs the
    chunks one by one."""


def _env_bool(key: str, default: bool = False) -> bool:
    raw = os.getenv(key)
    if raw is None:
        return default
    return str(raw).strip().lower() in ("1", "true", "yes", "on")


def _alignment_on() -> bool:
    """CHATTERBOX_ALIGNMENT=1 (read at call time): decode under the
    alignment guard (models/t3.py), meant for long-form and unattended
    synthesis, where a runaway or truncated chunk costs more than the spy
    layer's plain attention."""
    return _env_bool("CHATTERBOX_ALIGNMENT", False)


def _bucket_tokens(n: int) -> int:
    for b in _TOKEN_BUCKETS:
        if n <= b:
            return b
    return n


# S3Gen sub-batch model. These are the JAX package's values (its v5e
# calibration: a linear per-frame cost of the flash estimator, the share of
# free memory to fill, and the measured best live batch there), kept as
# they are; they are not measurements on an H100. Re-measuring them is
# later performance work (ROADMAP).
_S3GEN_FLASH_BYTES_PER_FRAME = 256 * 1024
_S3GEN_HBM_FRACTION = 0.7
_S3GEN_MAX_SUB = 16


def _derive_s3gen_sub_batch(u: int, n_tokens: int, *,
                            free_bytes: Optional[int] = None) -> int:
    """Utterances per S3Gen dispatch of a batch. CHATTERBOX_S3GEN_SUB_BATCH
    always wins. Otherwise the free device memory (`free_bytes`; None on
    the CPU, which has no limit) over the flash estimator's linear cost of
    the mel length T_mel = 2 * n_tokens (prompt + token bucket), capped at
    _S3GEN_MAX_SUB and u, snapped down to a power of two."""
    env = os.getenv("CHATTERBOX_S3GEN_SUB_BATCH")
    if env:
        return max(1, int(env))
    sub = _S3GEN_MAX_SUB
    if free_bytes is not None:
        per_utt = _S3GEN_FLASH_BYTES_PER_FRAME * 2 * max(1, int(n_tokens))
        sub = int(max(1, (free_bytes * _S3GEN_HBM_FRACTION) // per_utt))
    sub = min(sub, max(1, int(u)), _S3GEN_MAX_SUB)
    return 1 << (sub.bit_length() - 1)


def _derive_cfm_cache(rows: int) -> int:
    """DeepCache stride of the batched S3Gen pass (cfm.solve_euler
    cache_every). CHATTERBOX_CFM_CACHE always wins (0/1: the plain solver);
    otherwise K=2 from 8 live rows per dispatch, and the exact solver
    below (the JAX package's rule)."""
    env = os.getenv("CHATTERBOX_CFM_CACHE")
    if env is not None and env != "":
        return int(env)
    return 2 if rows >= 8 else 0


def _derive_cfm_cfg_steps():
    """CFG interval of the batched S3Gen pass (cfm.solve_euler cfg_steps):
    opt-in through CHATTERBOX_CFM_CFG_STEPS (<= 0 or unset: CFG on every
    step, None), as in the JAX package."""
    env = os.getenv("CHATTERBOX_CFM_CFG_STEPS")
    if env is not None and env != "":
        k = int(env)
        return None if k <= 0 else k
    return None


def download_checkpoints() -> Path:
    """The folder of CHECKPOINT_FILES from the hub's REPO_ID (downloaded
    into, or found in, huggingface_hub's cache)."""
    try:
        from huggingface_hub import hf_hub_download
    except ImportError as e:
        raise RuntimeError("huggingface_hub unavailable; use from_local()") from e
    local_path = None
    for f in CHECKPOINT_FILES:
        local_path = hf_hub_download(repo_id=REPO_ID, filename=f)
    return Path(local_path).parent


class ChatterboxTTS:
    ENC_COND_LEN = 6 * S3_SR
    DEC_COND_LEN = 10 * S3GEN_SR

    def __init__(self, t3_params, s3gen_params, tokenizer,
                 conds: Optional[Conditionals] = None,
                 config: ChatterboxConfig = ChatterboxConfig(),
                 dtype=torch.float32, device=None, ve_params=None):
        """t3_params / s3gen_params / ve_params: the port's trees (see
        weights.py); they are placed on `device` (None: the card), T3's and
        the flow's and vocoder's matmul and conv weights in `dtype`, the
        conditioning encoders (CAMPPlus, S3 tokenizer, voice encoder) in
        fp32. Without `ve_params` the pipeline speaks with prepared
        conditionals and voice profiles only."""
        self.sr = S3GEN_SR
        self.cfg = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.t3_params = place(t3_params, self.device, dtype)
        self.s3gen_params = place(s3gen_params, self.device, dtype, fp32=FP32_S3GEN)
        self.ve_params = (None if ve_params is None
                          else place(ve_params, self.device, torch.float32))
        # the stream's first-chunk graphs hold this model's weights: they go
        # when the pipeline does
        weakref.finalize(self, streaming.GRAPHS.release, self.s3gen_params["flow"])
        self.tokenizer = tokenizer
        self.conds = conds.to(self.device) if conds is not None else None
        self.watermarker = get_watermarker()
        # the long-text components
        self.smart_chunker = SmartChunker()
        self.param_manager = AdaptiveParameterManager()
        self.text_sanitizer = AdvancedTextSanitizer()
        self.quality_analyzer = ChunkQualityAnalyzer()
        self.advanced_stitcher = AdvancedStitcher(sample_rate=self.sr)
        self.prod_mode = _env_bool("CHATTERBOX_PROD_MODE")
        self.enable_quality_analysis = (_env_bool("CHATTERBOX_ENABLE_QUALITY_ANALYSIS")
                                        and not self.prod_mode)
        self.experiment_config = self._init_experiment_config()
        # conditional cache: the last prepared voice, by its key
        self._cached_conditionals: Optional[Conditionals] = None
        self._cache_key = None
        self._conditional_cache_hits = 0
        self._conditional_cache_misses = 0
        # the last request's stage timings and counts (_record_perf), and
        # their totals over a long-text job (_perf_acc_snapshot)
        self.perf: Dict[str, float] = {}
        self._perf_acc: Dict[str, float] = self._fresh_perf_acc()
        # per-voice S3Gen prompt rows on the device (_gen_device_voice_row)
        self._gen_dev_rows: Dict = {}
        # the serving mesh (enable_mesh); under it, the unsharded T3 too
        self.mesh = None
        self._t3_params_single = None

    def enable_mesh(self, n_devices: Optional[int] = None, tp: Optional[int] = None,
                    device=None):
        """Serve T3 over a dp x tp mesh (parallel.serve.make_dp_tp_mesh): the
        CFG rows split over dp, the backbone's Megatron layout over tp, one
        process a rank, this one rank 0. `generate`, `generate_batch`, long
        text and the continuous engine run their T3 over it; the CFG rows
        (2 an utterance) must divide dp. S3Gen and the conditioning run
        here, and `stream_generate` keeps the unsharded T3 on this card.

        n_devices: ranks, one a card (None: every visible card); tp as
        parallel.make_mesh. device: None for the cards; a device name puts
        every rank on that one device (the CPU; two ranks sharing a card).
        Rank 0 must run on this pipeline's device. Returns the mesh."""
        from .parallel import make_dp_tp_mesh, shard_t3_for_serving
        mesh = make_dp_tp_mesh(n_devices, tp=tp, device=device)
        if mesh.device != self.device:
            raise ValueError(f"the mesh's rank 0 runs on {mesh.device}, the pipeline on "
                             f"{self.device}")
        single = self._t3_single
        self.t3_params = shard_t3_for_serving(mesh, single)
        self.mesh, self._t3_params_single = mesh, single
        logger.info("serving mesh enabled: dp=%d tp=%d", mesh.dp, mesh.tp)
        return mesh

    @property
    def _t3_single(self):
        """T3's unsharded params on this card: what `stream_generate` and
        K4's wall read, on a mesh too."""
        return self._t3_params_single if self.mesh is not None else self.t3_params

    @classmethod
    def from_random(cls, seed: int = 0, config: ChatterboxConfig = ChatterboxConfig(),
                    tokenizer=None, dtype=torch.float32, device=None):
        """Randomly initialised pipeline, drawn on `device` (None: the card)
        from `seed`."""
        init = L.Init(seed, device)
        t3p = t3_mod.init(init, config.t3)
        s3p = s3gen_mod.init(init, config.s3gen)
        vep = ve_mod.init(init, config.voice_encoder)
        return cls(t3p, s3p, tokenizer or FallbackTokenizer(config.t3), conds=None,
                   config=config, dtype=dtype, device=init.device, ve_params=vep)

    @classmethod
    def from_local(cls, ckpt_dir, config: ChatterboxConfig = ChatterboxConfig(),
                   dtype=torch.float32, device=None, int8: Optional[bool] = None):
        """Load reference checkpoints: ve.safetensors, t3_cfg.safetensors,
        s3gen.safetensors, tokenizer.json and (if present) conds.pt in
        `ckpt_dir`. The port's numpy converters (utils/weights.py) build
        trees in the port's layout, which `weights.from_arrays` checks leaf
        by leaf and turns into tensors.

        int8: True quantises T3's backbone to int8 weights after the
        conversion (utils/quantize.quantize_t3), False keeps them full
        precision, None follows CHATTERBOX_INT8 (default off on a GPU; the
        JAX package's default of on is a TPU's). CHATTERBOX_INT8_S3GEN=1
        also quantises the flow stack (quantize_s3gen)."""
        from .utils.quantize import quantize_s3gen, quantize_t3
        if int8 is None:
            int8 = _env_bool("CHATTERBOX_INT8", False)
        ckpt_dir = Path(ckpt_dir)
        device = resolve_device(device)
        ve_sd = weights_mod.load_safetensors(str(ckpt_dir / "ve.safetensors"))
        ve_tree = weights_mod.convert_voice_encoder(ve_sd)
        t3_sd = weights_mod.load_safetensors(str(ckpt_dir / "t3_cfg.safetensors"))
        t3_tree = weights_mod.convert_t3(t3_sd, num_layers=config.t3.llama.num_layers)
        s3_sd = weights_mod.load_safetensors(str(ckpt_dir / "s3gen.safetensors"))
        s3_tree = weights_mod.convert_s3gen(s3_sd, cfg=config.s3gen)
        state = from_arrays(t3_tree, s3_tree, config, ve_params=ve_tree)
        if int8:
            state["t3"] = quantize_t3(state["t3"])
        if _env_bool("CHATTERBOX_INT8_S3GEN", False):
            state["s3gen"] = quantize_s3gen(state["s3gen"])
        tokenizer = EnTokenizer(str(ckpt_dir / "tokenizer.json"))
        conds = None
        if (ckpt_dir / "conds.pt").exists():
            conds = Conditionals.load(str(ckpt_dir / "conds.pt"), device=device)
        return cls(state["t3"], state["s3gen"], tokenizer, conds, config, dtype, device,
                   ve_params=state["ve"])

    @classmethod
    def from_pretrained(cls, device=None, **kw):
        """The reference checkpoints from the Hugging Face hub (REPO_ID; the
        JAX package's from_pretrained): huggingface_hub.hf_hub_download of
        CHECKPOINT_FILES, then from_local on their folder with `device` and
        `kw`. Raises RuntimeError when huggingface_hub cannot be imported."""
        return cls.from_local(download_checkpoints(), device=device, **kw)

    # ------------------------------------------------------------------
    # experiment switches (environment, read once at construction)
    # ------------------------------------------------------------------

    def _init_experiment_config(self) -> Dict[str, Any]:
        """The JAX package's CHATTERBOX_EXPERIMENT_* switches of the
        long-text gates: all on unless CHATTERBOX_EXPERIMENT_MODE is set;
        ISSUE_ONLY_MODE keeps only the token guards and the silence gate."""
        cfg = {
            "enabled": _env_bool("CHATTERBOX_EXPERIMENT_MODE", False),
            "name": os.getenv("CHATTERBOX_EXPERIMENT_NAME", "default"),
            "issue_only_mode": _env_bool("CHATTERBOX_EXPERIMENT_ISSUE_ONLY_MODE", False),
            "enable_token_guards": _env_bool("CHATTERBOX_EXPERIMENT_ENABLE_TOKEN_GUARDS", True),
            "enable_silence_gate": _env_bool("CHATTERBOX_EXPERIMENT_ENABLE_SILENCE_GATE", True),
            "enable_qa_regen": _env_bool("CHATTERBOX_EXPERIMENT_ENABLE_QA_REGEN", True),
            "enable_retry_param_drift": _env_bool(
                "CHATTERBOX_EXPERIMENT_ENABLE_RETRY_PARAM_DRIFT", True),
            "enable_adaptive_voice_params": _env_bool(
                "CHATTERBOX_EXPERIMENT_ENABLE_ADAPTIVE_VOICE_PARAMS", True),
            "force_adaptive_blend": None,
        }
        raw = os.getenv("CHATTERBOX_EXPERIMENT_FORCE_ADAPTIVE_BLEND")
        if raw:
            try:
                cfg["force_adaptive_blend"] = max(0.0, min(1.0, float(raw)))
            except ValueError:
                pass
        if not cfg["enabled"]:
            cfg.update(name="off", issue_only_mode=False, enable_token_guards=True,
                       enable_silence_gate=True, enable_qa_regen=True,
                       enable_retry_param_drift=True, enable_adaptive_voice_params=True,
                       force_adaptive_blend=None)
        elif cfg["issue_only_mode"]:
            cfg.update(enable_retry_param_drift=False, enable_adaptive_voice_params=False,
                       enable_qa_regen=False)
        return cfg

    # ------------------------------------------------------------------
    # warm-up
    # ------------------------------------------------------------------

    def warmup(self, batch_sizes=(1,), max_new_tokens: int = 1000,
               token_buckets=(256,), stream: bool = False) -> Dict[str, float]:
        """Run the serving shapes once before the first request: on the card
        build every serving kernel (K1/K1s, K2, K3, K4: one nvcc each, all
        started together) and, under CHATTERBOX_FUSED_STEP=1 with a backbone
        that is not int8, stack K4's weight wall; then the JAX package's stages: `generate` or
        `generate_batch` per batch size, `_run_s3gen` per token bucket and
        optionally a stream's first chunk at `max_new_tokens` (on the card
        this captures the first-chunk graph of its text bucket and cache
        capacity, which stream_generate's requests at that cap replay; the
        JAX package warms its program at a cap of 50).

        Uses the prepared conditionals when present, else prepares
        throwaway ones from a synthetic 10 s tone and restores the
        conditional-cache state afterwards. Returns {stage: seconds}. A
        stage that trips the token guard is skipped (the JAX package skips a
        failed stage); any other error propagates."""
        timings: Dict[str, float] = {}
        saved = (self.conds, self._cached_conditionals, self._cache_key)
        tmp = None

        def stage(name, fn):
            t0 = time.time()
            try:
                fn()
            except TokenGuardError:
                logger.warning("warmup stage %s tripped the token guard (skipped)", name)
                return
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            timings[name] = time.time() - t0

        if self.device.type == "cuda":
            stage("kernels_s", _build_serving_kernels)
            if (t3_mod._use_fused_step() and t3_mod.fused_weights(self._t3_single)
                    and t3_mod.fused_decode.plan(self.cfg.t3.llama, 2) is not None):
                stage("fused_wall_s", lambda: t3_mod._fused_params(
                    self._t3_single, self.cfg.t3, self.dtype))
        try:
            if self.conds is None:
                fd, tmp = tempfile.mkstemp(suffix=".wav")
                os.close(fd)
                t = np.arange(self.DEC_COND_LEN) / S3GEN_SR
                wav = (0.2 * np.sin(2 * np.pi * 180 * t)
                       * (1 + 0.3 * np.sin(2 * np.pi * 2.5 * t))).astype(np.float32)
                audio_io.write_wav(tmp, wav, S3GEN_SR)
                stage("conditionals_s", lambda: self.prepare_conditionals_with_audio_prompt(tmp))
            text = "This warmup sentence compiles the serving shape buckets."
            for b in batch_sizes:
                if b == 1:
                    stage("batch1_s", lambda: self.generate(
                        text, max_new_tokens=max_new_tokens, seed=0))
                else:
                    stage(f"batch{b}_s", lambda b=b: self.generate_batch(
                        [text] * b, max_new_tokens=max_new_tokens, seed=0))
            gen = self.conds.gen
            for bkt in token_buckets:
                stage(f"tokens{bkt}_s", lambda bkt=bkt: self._run_s3gen(
                    np.zeros((int(bkt),), np.int32), gen, seed=0))
            if stream:
                stage("stream_first_chunk_s", lambda: next(iter(
                    self.stream_generate(text, max_new_tokens=max_new_tokens, seed=0))))
        finally:
            if tmp is not None:
                self.conds, self._cached_conditionals, self._cache_key = saved
                os.unlink(tmp)
        logger.info("warmup: %s", {k: round(v, 2) for k, v in timings.items()})
        return timings

    # ------------------------------------------------------------------
    # conditional preparation + cache
    # ------------------------------------------------------------------

    def _get_or_prepare_conditionals(self, voice_profile_path=None, saved_voice_path=None,
                                     audio_prompt_path=None, exaggeration=0.5) -> Conditionals:
        if voice_profile_path:
            key = ("voice_profile", voice_profile_path, exaggeration)
        elif saved_voice_path and audio_prompt_path:
            key = ("saved_voice", saved_voice_path, audio_prompt_path, exaggeration)
        elif audio_prompt_path:
            key = ("audio_prompt", audio_prompt_path, exaggeration)
        else:
            raise ValueError("Must provide one of: voice_profile_path, "
                             "(saved_voice_path + audio_prompt_path), or audio_prompt_path")
        if self._cached_conditionals is not None and key == self._cache_key:
            self._conditional_cache_hits += 1
            return self._cached_conditionals
        self._conditional_cache_misses += 1
        self._prepare(voice_profile_path, saved_voice_path, audio_prompt_path, exaggeration)
        self._cache_key = key
        return self._cached_conditionals

    def _prepare(self, voice_profile_path, saved_voice_path, audio_prompt_path, exaggeration):
        if voice_profile_path:
            self.prepare_conditionals_with_voice_profile(voice_profile_path, exaggeration)
        elif saved_voice_path and audio_prompt_path:
            self.prepare_conditionals_with_saved_voice(saved_voice_path, audio_prompt_path,
                                                       exaggeration)
        else:
            self.prepare_conditionals_with_audio_prompt(audio_prompt_path, exaggeration)

    def clear_conditional_cache(self):
        self._cached_conditionals = None
        self._cache_key = None

    def get_conditional_cache_stats(self) -> Dict[str, Any]:
        total = self._conditional_cache_hits + self._conditional_cache_misses
        return {"hits": self._conditional_cache_hits,
                "misses": self._conditional_cache_misses,
                "total_requests": total,
                "hit_rate_percent": 100.0 * self._conditional_cache_hits / total if total else 0.0,
                "cache_size": 1 if self._cached_conditionals is not None else 0}

    def prepare_conditionals_with_voice_profile(self, voice_profile_path: str,
                                                exaggeration: float = 0.5):
        profile = self.load_voice_profile(voice_profile_path)
        gen = dict(prompt_token=profile.prompt_token,
                   prompt_token_len=profile.prompt_token_len,
                   prompt_feat=profile.prompt_feat,
                   prompt_feat_len=profile.prompt_feat_len,
                   embedding=profile.embedding)
        plen = self.cfg.t3.speech_cond_prompt_len
        t3_tokens = np.asarray(profile.prompt_token)[:, :plen] if plen else None
        if profile.ve_embedding is None:
            raise ValueError("Voice profile missing ve_embedding")
        t3c = T3Cond(
            speaker_emb=torch.as_tensor(np.asarray(profile.ve_embedding), dtype=torch.float32),
            cond_prompt_speech_tokens=(None if t3_tokens is None else
                                       torch.as_tensor(t3_tokens, dtype=torch.int32)),
            emotion_adv=float(exaggeration))
        self._set_conds(Conditionals(t3c, gen))

    def prepare_conditionals_with_saved_voice(self, saved_voice_path: str,
                                              prompt_audio_path: str, exaggeration=0.5):
        """A saved CAMPPlus embedding with fresh prompt features."""
        self._need_ve()
        saved_emb = np.load(saved_voice_path)
        rd = self._build_ref_dict(prompt_audio_path)
        rd["embedding"] = saved_emb
        t3c = self._build_t3_cond(prompt_audio_path, exaggeration)
        self._set_conds(Conditionals(t3c, rd))

    def prepare_conditionals_with_audio_prompt(self, wav_fpath: str, exaggeration=0.5,
                                               timings: Optional[dict] = None):
        """`timings`: optional dict that receives the seconds of each part
        (resample, mel, campplus, tokenizer, voice_encoder); asking for them
        makes the device wait after every part."""
        self._need_ve()
        rd = self._build_ref_dict(wav_fpath, timings)
        t3c = self._build_t3_cond(wav_fpath, exaggeration, timings)
        self._set_conds(Conditionals(t3c, rd))

    def _set_conds(self, conds: Conditionals):
        conds = conds.to(self.device)
        self._cached_conditionals = conds
        self.conds = conds

    def _need_ve(self):
        if self.ve_params is None:
            raise RuntimeError("conditioning from audio needs the voice encoder: "
                               "pass ve_params (from_random and from_local do)")

    def _build_ref_dict(self, audio_path: str, timings: Optional[dict] = None
                        ) -> Dict[str, np.ndarray]:
        t0 = time.time()
        wav24, _ = audio_io.load_audio(audio_path, sr=S3GEN_SR, device=self.device)
        wav24 = wav24[: self.DEC_COND_LEN]
        lap(timings, "resample_s", t0, self.device)
        return s3gen_mod.embed_ref(self.s3gen_params, wav24, S3GEN_SR, self.cfg.s3gen,
                                   timings=timings)

    def _build_t3_cond(self, audio_path: str, exaggeration: float,
                       timings: Optional[dict] = None) -> T3Cond:
        t0 = time.time()
        wav16, _ = audio_io.load_audio(audio_path, sr=S3_SR, device=self.device)
        t0 = lap(timings, "resample_s", t0, self.device)
        plen = self.cfg.t3.speech_cond_prompt_len
        prompt_tokens = None
        if plen:
            wavp = s3tok_mod.pad_to_token_multiple(wav16[: self.ENC_COND_LEN])
            toks, _ = s3tok_mod.tokenize_wave(
                self.s3gen_params["tokenizer"], torch.from_numpy(wavp)[None].to(self.device),
                max_len=plen, cfg=self.cfg.s3gen.tokenizer)
            prompt_tokens = toks.to(torch.int32)
            t0 = lap(timings, "tokenizer_s", t0, self.device)
        ve_embed = self._ve_embedding(wav16)
        lap(timings, "voice_encoder_s", t0, self.device)
        return T3Cond(speaker_emb=torch.from_numpy(ve_embed),
                      cond_prompt_speech_tokens=prompt_tokens,
                      emotion_adv=float(exaggeration))

    def _ve_embedding(self, wav16: np.ndarray) -> np.ndarray:
        """(1, 256) fp32 voice-encoder embedding of one 16 kHz wav."""
        ve_embed = ve_mod.embeds_from_wavs(self.ve_params, [wav16], S3_SR,
                                           self.cfg.voice_encoder)
        return ve_embed.mean(axis=0, keepdims=True).astype(np.float32)

    # ------------------------------------------------------------------
    # voice clone / profile I/O
    # ------------------------------------------------------------------

    def save_voice_clone(self, audio_file_path: str, save_path: str):
        wav, sr = audio_io.load_audio(audio_file_path)
        s3gen_mod.save_voice_clone(self.s3gen_params, wav, sr, save_path, self.cfg.s3gen)

    def save_voice_profile(self, audio_file_path: str, save_path: str):
        self._need_ve()
        wav, sr = audio_io.load_audio(audio_file_path)
        rd = s3gen_mod.embed_ref(self.s3gen_params, wav, sr, self.cfg.s3gen)
        wav16, _ = audio_io.load_audio(audio_file_path, sr=S3_SR, device=self.device)
        VoiceProfile(embedding=rd["embedding"], prompt_feat=rd["prompt_feat"],
                     prompt_feat_len=rd["prompt_feat_len"], prompt_token=rd["prompt_token"],
                     prompt_token_len=rd["prompt_token_len"],
                     ve_embedding=self._ve_embedding(wav16)).save(save_path)

    def load_voice_clone(self, path: str) -> np.ndarray:
        return np.load(path)

    def load_voice_profile(self, path: str) -> VoiceProfile:
        return VoiceProfile.load(path)

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    @staticmethod
    def _fresh_perf_acc() -> Dict[str, float]:
        return {"t3_s": 0.0, "s3gen_s": 0.0, "speech_tokens": 0, "decode_steps": 0,
                "samples": 0, "requests": 0}

    def _perf_acc_snapshot(self) -> Dict[str, float]:
        """The totals of every request since the job began (a long-text
        job's first pass and retries), with their rates."""
        acc = self._perf_acc
        audio_s = acc["samples"] / float(self.sr)
        total = acc["t3_s"] + acc["s3gen_s"]
        return {
            "t3_s": acc["t3_s"], "s3gen_s": acc["s3gen_s"], "total_s": total,
            "speech_tokens": int(acc["speech_tokens"]),
            "decode_steps": int(acc["decode_steps"]),
            "tokens_per_s": acc["speech_tokens"] / acc["t3_s"] if acc["t3_s"] > 0 else 0.0,
            "audio_s": audio_s,
            "rtf": total / audio_s if audio_s > 0 else 0.0,
            "requests": int(acc["requests"]),
        }

    def _record_perf(self, t3_s: float, s3gen_s: float, tokens: int,
                     samples: int, decode_steps: int, batch: int = 1) -> Dict[str, float]:
        """The last request's stage timings (host clock around work that
        ends in a device->host copy) and counts, also folded into the job's
        totals; for a batch, rtf is the stage seconds over the summed audio
        seconds."""
        total = t3_s + s3gen_s
        audio_s = samples / float(self.sr)
        self.perf = {
            "t3_s": t3_s, "s3gen_s": s3gen_s, "total_s": total,
            "speech_tokens": int(tokens), "decode_steps": int(decode_steps),
            "tokens_per_s": tokens / t3_s if t3_s > 0 else 0.0,
            "audio_s": audio_s,
            "rtf": total / audio_s if audio_s > 0 else 0.0,
            "batch": int(batch),
        }
        acc = self._perf_acc
        acc["t3_s"] += t3_s
        acc["s3gen_s"] += s3gen_s
        acc["speech_tokens"] += int(tokens)
        acc["decode_steps"] += int(decode_steps)
        acc["samples"] += int(samples)
        acc["requests"] += int(batch)
        return self.perf

    def _run_t3(self, text: str, conds: Conditionals, *, temperature, cfg_weight,
                repetition_penalty, min_p, top_p, max_new_tokens, seed, draws,
                info: dict) -> np.ndarray:
        tok = self.tokenizer.text_to_tokens(text)[0]
        sot, eot = self.cfg.t3.start_text_token, self.cfg.t3.stop_text_token
        text_tokens = np.concatenate([[sot], tok, [eot]]).astype(np.int32)[None]
        speech = t3_mod.generate(
            self.t3_params, conds.t3, text_tokens, max_new_tokens=max_new_tokens,
            temperature=temperature, cfg_weight=cfg_weight,
            repetition_penalty=repetition_penalty, min_p=min_p, top_p=top_p,
            seed=seed, draws=draws, alignment=_alignment_on(), cfg=self.cfg.t3,
            dtype=self.dtype, device=self.device, info=info, mesh=self.mesh)
        # the JAX package's two steps: cut between the first SOS and the
        # first EOS, then keep the speech ids
        return s3gen_mod.drop_invalid_tokens(s3tok_mod.drop_invalid_tokens(speech))

    def _run_s3gen(self, speech_tokens: np.ndarray, gen: Dict, seed: int = 0,
                   draws=None) -> np.ndarray:
        """tokens -> wav through the bucketed graph; returns (T,) float32."""
        n = int(speech_tokens.shape[-1])
        bkt = _bucket_tokens(n)
        toks = np.zeros((1, bkt), np.int64)
        toks[0, :n] = speech_tokens
        dev = self.device
        prompt_len = int(np.asarray(gen["prompt_token_len"]).reshape(-1)[0])
        wav = s3gen_mod.token_to_wav(
            self.s3gen_params, torch.from_numpy(toks).to(dev),
            torch.tensor([prompt_len + n], device=dev),
            torch.as_tensor(np.asarray(gen["prompt_token"]), dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(gen["prompt_feat"]), dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(gen["embedding"]), dtype=torch.float32, device=dev),
            draws if draws is not None else Draws(seed, dev),
            cfg=self.cfg.s3gen, dtype=self.dtype)
        n_samples = 2 * n * 480  # mel rate 50 Hz x 480 samples/frame
        return wav[0, :n_samples].float().cpu().numpy()

    def _guard_tokens(self, speech_tokens: np.ndarray):
        if not self.experiment_config.get("enable_token_guards", True):
            return
        if speech_tokens.size == 0:
            raise TokenGuardError("T3 produced empty speech token sequence (likely early EOS)")
        if speech_tokens.size < 8:
            raise TokenGuardError(
                f"T3 produced too few speech tokens after filtering ({speech_tokens.size} < 8)")

    def generate(self, text, repetition_penalty=1.2, min_p=0.05, top_p=1.0,
                 audio_prompt_path=None, saved_voice_path=None, voice_profile_path=None,
                 exaggeration=0.5, cfg_weight=0.3, temperature=0.6, max_new_tokens=1000,
                 seed=0, draws=None) -> np.ndarray:
        """Single-utterance TTS. Returns (1, T). With no conditionals
        prepared, the voice comes from `voice_profile_path`, from
        `saved_voice_path` with `audio_prompt_path`, or from
        `audio_prompt_path` (with `exaggeration` as the emotion); prepared
        conditionals are kept as they are.

        draws: optional draw source for the T3 Gumbel noise and the HiFT
        phases and noise; by default each stage draws from its own
        `Draws(seed, device)`."""
        if self.conds is None:
            if not (voice_profile_path or audio_prompt_path):
                raise RuntimeError(
                    "Conditionals are not prepared. Provide voice_profile_path, "
                    "(saved_voice_path + audio_prompt_path), or audio_prompt_path.")
            self._prepare(voice_profile_path, saved_voice_path, audio_prompt_path, exaggeration)
        info: dict = {}
        t0 = time.time()
        speech_tokens = self._run_t3(
            text, self.conds, temperature=temperature, cfg_weight=cfg_weight,
            repetition_penalty=repetition_penalty, min_p=min_p, top_p=top_p,
            max_new_tokens=max_new_tokens, seed=seed, draws=draws, info=info)
        t3_s = time.time() - t0
        self._guard_tokens(speech_tokens)
        t0 = time.time()
        wav = self._run_s3gen(speech_tokens, self.conds.gen, seed=seed, draws=draws)
        self._record_perf(t3_s, time.time() - t0, speech_tokens.size, wav.size,
                          info["decode_steps"])
        self.perf["use_fused"] = bool(info["use_fused"])
        return wav[None, :]

    # ------------------------------------------------------------------
    # streaming
    # ------------------------------------------------------------------

    def stream_generate(self, text, *, block_tokens: int = 25,
                        throughput_block_tokens: int = 300, repetition_penalty=1.2,
                        min_p=0.05, top_p=1.0, cfg_weight=0.3, temperature=0.6,
                        max_new_tokens=1000, seed=0, draws=None):
        """Yield waveform chunks (float32 numpy, 24 kHz) as tokens decode,
        with the prepared conditionals.

        The first chunk (context, prefill, `block_tokens` decode steps, the
        first flow and vocoder windows) is one program, streaming.
        first_chunk: on the card one CUDA graph replay per text bucket (the
        first request of a bucket captures it), then one copy to the host;
        the decode resumes from its state (streaming.continue_tokens) and
        streaming.WindowedSynth synthesises the later token groups as they
        fill, from `block_tokens` growing to `throughput_block_tokens`.
        CHATTERBOX_FUSED_FIRST_CHUNK=0, or a cfg_weight of 0 (which the
        program does not take), streams every block through the per-block
        route instead (t3.generate_stream feeding WindowedSynth), the JAX
        package's two routes. When the decode ends within the first
        pre-lookahead tokens the program emits no audio, and its tokens go
        through the windowed loop, whose final window is the per-block
        route's.

        draws: one source for the T3 Gumbel noise and the vocoder windows'
        draws (`Draws(seed, device)` by default). After the last chunk,
        self.perf holds first_chunk_s (host clock from the first request for
        a chunk to the first chunk in host memory), total_s, speech_tokens,
        decode_steps, chunks, audio_s, use_fused (the fused decode step),
        fused_first_chunk (the route) and first_chunk_graph ("captured",
        "replayed", "eager" off the card, None on the per-block route)."""
        if self.conds is None:
            raise RuntimeError("Conditionals are not prepared: pass conds= (or a "
                               "conds.pt through from_local)")
        t0 = time.time()
        dev = self.device
        prompt_token, prompt_feat, embedding = self._gen_tensors(self.conds.gen)
        tok = self.tokenizer.text_to_tokens(text)[0]
        sot, eot = self.cfg.t3.start_text_token, self.cfg.t3.stop_text_token
        text_tokens = np.concatenate([[sot], tok, [eot]]).astype(np.int32)[None]
        draws = draws if draws is not None else Draws(seed, dev)
        synth = streaming.WindowedSynth(
            self.s3gen_params, prompt_token, prompt_feat, embedding, draws=draws,
            cfg=self.cfg, dtype=self.dtype, block_tokens=block_tokens,
            throughput_block_tokens=throughput_block_tokens)
        stats = dict(first_chunk_s=None, chunks=0, samples=0)

        def emit(chunks):
            for c in chunks:
                if stats["first_chunk_s"] is None:
                    stats["first_chunk_s"] = time.time() - t0
                stats["chunks"] += 1
                stats["samples"] += c.size
                yield c

        info: dict = {}
        tokens = []
        cw = np.asarray(cfg_weight, np.float32)
        fused_first = (cw.size == 1 and float(cw) > 0.0
                       and os.getenv("CHATTERBOX_FUSED_FIRST_CHUNK", "1") != "0")
        if fused_first:
            fc, resume = streaming.first_chunk(
                self._t3_single, self.s3gen_params, self.conds.t3, text_tokens,
                prompt_tokens=prompt_token, prompt_feat=prompt_feat, embedding=embedding,
                block_tokens=block_tokens, max_new_tokens=max_new_tokens,
                temperature=temperature, cfg_weight=cfg_weight,
                repetition_penalty=repetition_penalty, min_p=min_p, top_p=top_p, seed=seed,
                voc_ctx=synth.M, cfg=self.cfg, dtype=self.dtype, draws=draws, device=dev)
            toks, n_new, n_valid_mel, wav, _ = streaming.host_fields(fc)
            toks = toks[:n_new]
            tokens.append(toks)
            valid = toks[toks < SPEECH_VOCAB_SIZE]
            if n_valid_mel > 0:
                # the windowed loop goes on where the program left off
                synth.seed_from_fused(valid, fc.mu_tail, fc.mel_tail[:, :min(synth.M, n_valid_mel)],
                                      fc.phase_carry)
                yield from emit([wav[: n_valid_mel * synth.up].copy()])
            else:
                # the decode ended within the pre-lookahead: no audio yet, and
                # the tokens go through the windowed loop, whose final window
                # is the per-block route's first
                yield from emit(synth.feed(valid))
            token_stream = streaming.continue_tokens(self._t3_single, fc, resume, cfg=self.cfg,
                                                     dtype=self.dtype)
            info.update(use_fused=resume["ginfo"]["use_fused"])
        else:
            token_stream = t3_mod.generate_stream(
                self._t3_single, self.conds.t3, text_tokens, max_new_tokens=max_new_tokens,
                temperature=temperature, cfg_weight=cfg_weight,
                repetition_penalty=repetition_penalty, min_p=min_p, top_p=top_p, seed=seed,
                block=block_tokens, draws=draws, cfg=self.cfg.t3, dtype=self.dtype, device=dev,
                info=info)
        for block in token_stream:
            tokens.append(block)
            yield from emit(synth.feed(block))
        yield from emit(synth.finish())
        speech = s3gen_mod.drop_invalid_tokens(s3tok_mod.drop_invalid_tokens(
            np.concatenate(tokens) if tokens else np.zeros((0,), np.int32)))
        steps = resume["decode_steps"] if fused_first else info["decode_steps"]
        self.perf = {"first_chunk_s": stats["first_chunk_s"], "total_s": time.time() - t0,
                     "speech_tokens": int(speech.size), "decode_steps": int(steps),
                     "chunks": stats["chunks"], "audio_s": stats["samples"] / float(self.sr),
                     "use_fused": bool(info["use_fused"]), "fused_first_chunk": fused_first,
                     "first_chunk_graph": resume["route"] if fused_first else None}

    def _gen_tensors(self, gen: Dict):
        """A voice's S3Gen prompt on the device: (prompt_token int64,
        prompt_feat fp32, embedding fp32), one row each."""
        dev = self.device
        return (torch.as_tensor(np.asarray(gen["prompt_token"]), dtype=torch.int64, device=dev),
                torch.as_tensor(np.asarray(gen["prompt_feat"]), dtype=torch.float32,
                                device=dev),
                torch.as_tensor(np.asarray(gen["embedding"]), dtype=torch.float32, device=dev))

    # ------------------------------------------------------------------
    # batched generation
    # ------------------------------------------------------------------

    def generate_batch(self, texts, repetition_penalty=1.2, min_p=0.05, top_p=1.0,
                       exaggeration=None, cfg_weight=0.3, temperature=0.6,
                       max_new_tokens=1000, seed=0, conds=None,
                       make_draws=None) -> List[np.ndarray]:
        """Batched TTS: many sentences in one lock-step T3 decode, then
        S3Gen over the padded batch in sub-batches. Returns a list of (T_i,)
        float32 waveforms.

        Every sampling parameter (and `exaggeration`) is one scalar for all
        rows or a length-U sequence. `exaggeration=None` keeps the
        conditionals' emotion. `conds` is None (the prepared voice), one
        Conditionals, or a sequence of them, one per text (multi-voice: T3
        takes per-row conditioning rows, S3Gen ragged per-row prompts).

        make_draws: draw-source factory, called with seed + s0 for the T3
        sub-batch from row s0 and with `seed` for every S3Gen dispatch
        (default `Draws(s, device)`). Voices that cannot share one batch
        raise VoiceBatchError."""
        multi = isinstance(conds, (list, tuple))
        dev = self.device
        if multi:
            conds_list = [c.to(dev) for c in conds]
            if len(conds_list) != len(texts):
                raise VoiceBatchError(f"multi-voice: {len(conds_list)} Conditionals for "
                                      f"{len(texts)} texts")
            pts = [c.t3.cond_prompt_speech_tokens for c in conds_list]
            if len({None if p is None else p.shape[-1] for p in pts}) != 1:
                raise VoiceBatchError("multi-voice: T3 cond prompt lengths must match")
            t3_cond = t3_mod.T3Cond(
                speaker_emb=torch.cat([c.t3.speaker_emb.reshape(1, -1) for c in conds_list]),
                cond_prompt_speech_tokens=(None if pts[0] is None else torch.cat(
                    [p.reshape(1, p.shape[-1]) for p in pts])),
                emotion_adv=torch.tensor(
                    [float(torch.as_tensor(c.t3.emotion_adv).reshape(-1)[0])
                     for c in conds_list], dtype=torch.float32, device=dev))
        else:
            conds = conds.to(dev) if conds is not None else self.conds
            if conds is None:
                raise RuntimeError("Conditionals are not prepared: pass conds= (or a "
                                   "conds.pt through from_local)")
            t3_cond = conds.t3
        if exaggeration is not None:
            emo = np.asarray(exaggeration, np.float32).reshape(-1)
            t3_cond = t3_cond._replace(
                emotion_adv=torch.from_numpy(emo).to(dev) if emo.size > 1 else float(emo[0]))
        sot, eot = self.cfg.t3.start_text_token, self.cfg.t3.stop_text_token
        rows = [np.concatenate([[sot], self.tokenizer.text_to_tokens(t)[0], [eot]])
                for t in texts]
        text_tokens = np.full((len(rows), max(len(r) for r in rows)), eot, np.int32)
        for i, r in enumerate(rows):
            text_tokens[i, :len(r)] = r
        text_lens = np.asarray([len(r) for r in rows], np.int32)

        info: dict = {}
        t0 = time.time()
        token_lists = t3_mod.generate_batch(
            self.t3_params, t3_cond, text_tokens, max_new_tokens=max_new_tokens,
            temperature=temperature, cfg_weight=cfg_weight,
            repetition_penalty=repetition_penalty, min_p=min_p, top_p=top_p,
            seed=seed, text_lens=text_lens, make_draws=make_draws,
            alignment=_alignment_on(), cfg=self.cfg.t3, dtype=self.dtype, device=dev,
            info=info, mesh=self.mesh)
        t3_s = time.time() - t0
        t0 = time.time()
        outs, lens, vinfo = self._vocode_batch(
            token_lists, conds=None if multi else conds,
            conds_list=conds_list if multi else None, seed=seed, make_draws=make_draws)
        self._record_perf(t3_s, time.time() - t0, int(np.sum(lens)),
                          int(sum(w.size for w in outs)), info["decode_steps"],
                          batch=len(texts))
        self.perf.update(decode_sub_batches=info["sub_batches"],
                         row_tokens=[int(n) for n in lens], **vinfo)
        return outs

    def _vocode_batch(self, token_lists, *, conds=None, conds_list=None, seed: int = 0,
                      make_draws=None):
        """Tokens -> wavs for a batch: the S3Gen tail of `generate_batch`.
        One voice (`conds`) is one prompt row expanded on the device; many
        (`conds_list`, one per row) run ragged per-row prompts. Every
        dispatch is enqueued before the first wav is fetched. Returns (list
        of (T_i,) float32 wavs, cleaned token counts, dispatch info)."""
        dev = self.device
        with profiling.span("s3gen.prepare"):
            u = len(token_lists)
            token_lists = [s3gen_mod.drop_invalid_tokens(s3tok_mod.drop_invalid_tokens(t))
                           for t in token_lists]
            lens = [len(t) for t in token_lists]
            bkt = _bucket_tokens(max([1] + lens))
            toks = np.zeros((u, bkt), np.int64)
            for i, t in enumerate(token_lists):
                toks[i, :len(t)] = t
            if conds_list is not None:
                bundle = self._gen_device_multi(conds_list)
                prompt_token, prompt_feat = bundle["prompt_token"], bundle["prompt_feat"]
                embedding, p_lens = bundle["embedding"], bundle["prompt_len"]
                prompt_len = torch.from_numpy(p_lens).to(dev)
                n_prompt_w = bundle["p_bkt"]
            else:
                gen = conds.gen
                n_prompt = int(np.asarray(gen["prompt_token_len"]).reshape(-1)[0])
                prompt_token = torch.as_tensor(np.asarray(gen["prompt_token"]), dtype=torch.int64,
                                               device=dev).expand(u, -1)
                prompt_feat = torch.as_tensor(np.asarray(gen["prompt_feat"]), dtype=torch.float32,
                                              device=dev).expand(u, -1, -1)
                embedding = torch.as_tensor(np.asarray(gen["embedding"]), dtype=torch.float32,
                                            device=dev).expand(u, -1)
                p_lens = np.full((u,), n_prompt, np.int64)
                prompt_len = None
                n_prompt_w = n_prompt
            token_len = torch.from_numpy(p_lens + np.asarray(lens, np.int64)).to(dev)
            toks = torch.from_numpy(toks).to(dev)
            sub = _derive_s3gen_sub_batch(u, n_prompt_w + bkt,
                                          free_bytes=t3_mod.free_device_bytes(dev))
            # one solver setting for every dispatch of the request: the last,
            # partial sub-batch must not change the numerics
            cache_every = _derive_cfm_cache(min(sub, u))
            cfg_steps = _derive_cfm_cfg_steps()
            make_draws = make_draws or (lambda s: Draws(s, dev))
        wavs = []
        for k, s0 in enumerate(range(0, u, sub)):
            s1 = min(u, s0 + sub)
            with profiling.span("s3gen.dispatch", dispatch=k, rows=s1 - s0,
                                cache_every=cache_every):
                wavs.append((s0, s1, s3gen_mod.token_to_wav(
                    self.s3gen_params, toks[s0:s1], token_len[s0:s1], prompt_token[s0:s1],
                    prompt_feat[s0:s1], embedding[s0:s1], make_draws(seed),
                    cfg=self.cfg.s3gen, dtype=self.dtype,
                    prompt_len=None if prompt_len is None else prompt_len[s0:s1],
                    cache_every=cache_every, cfg_steps=cfg_steps)))
        outs = []
        for k, (s0, s1, wav) in enumerate(wavs):
            with profiling.span("s3gen.fetch", dispatch=k):
                wav = wav.float().cpu().numpy()
            outs.extend(wav[i, : 2 * lens[s0 + i] * 480] for i in range(s1 - s0))
        vinfo = dict(s3gen_sub_batch=sub, s3gen_dispatches=len(wavs),
                     cfm_cache_every=cache_every, cfm_cfg_steps=cfg_steps)
        return outs, lens, vinfo

    def _gen_device_voice_row(self, gen: Dict, p_bkt: int, n_mel: int) -> Dict:
        """One voice's S3Gen prompt as (1, ...) device rows padded to the
        prompt bucket `p_bkt`, kept per (voice, bucket) so a voice moves to
        the device once."""
        key = (id(gen), p_bkt)
        row = self._gen_dev_rows.get(key)
        if row is not None:
            return row
        p = int(np.asarray(gen["prompt_token_len"]).reshape(-1)[0])
        pt = np.zeros((1, p_bkt), np.int64)
        pt[0, :p] = np.asarray(gen["prompt_token"]).reshape(1, -1)[0, :p]
        feat = np.asarray(gen["prompt_feat"])
        feat = feat.reshape(feat.shape[-2], feat.shape[-1])[: 2 * p]
        pf = np.zeros((1, 2 * p_bkt, n_mel), np.float32)
        pf[0, : feat.shape[0]] = feat
        em = np.asarray(gen["embedding"], np.float32).reshape(1, -1)
        dev = self.device
        row = dict(pt=torch.from_numpy(pt).to(dev), pf=torch.from_numpy(pf).to(dev),
                   em=torch.from_numpy(em).to(dev), p=p,
                   _pin=gen)   # pin the dict so its id is not reused
        if len(self._gen_dev_rows) >= 64:
            self._gen_dev_rows.pop(next(iter(self._gen_dev_rows)))
        self._gen_dev_rows[key] = row
        return row

    def _gen_device_multi(self, conds_list) -> Dict:
        """The stacked S3Gen prompts of a multi-voice batch: per-voice rows
        padded to a shared 64-multiple prompt bucket, with each row's valid
        prompt length."""
        p_lens = [int(np.asarray(c.gen["prompt_token_len"]).reshape(-1)[0])
                  for c in conds_list]
        p_bkt = max(64, -(-max(p_lens) // 64) * 64)
        n_mel = int(np.asarray(conds_list[0].gen["prompt_feat"]).shape[-1])
        rows = [self._gen_device_voice_row(c.gen, p_bkt, n_mel) for c in conds_list]
        return dict(prompt_token=torch.cat([r["pt"] for r in rows]),
                    prompt_feat=torch.cat([r["pf"] for r in rows]),
                    embedding=torch.cat([r["em"] for r in rows]),
                    prompt_len=np.asarray(p_lens, np.int64), p_bkt=p_bkt)

    # ------------------------------------------------------------------
    # long text: chunk -> pooled batch -> retry -> stitch -> watermark
    # ------------------------------------------------------------------

    def _generate_with_prepared_conditionals(self, text: str, conditionals: Conditionals,
                                             exaggeration=None, repetition_penalty=1.2,
                                             min_p=0.05, top_p=1.0, cfg_weight=0.3,
                                             temperature=0.6,
                                             max_new_tokens_override: Optional[int] = None,
                                             return_token_count: bool = False, seed: int = 0,
                                             draws=None):
        """One utterance with the given conditionals (emotion replaced when
        `exaggeration` is given): T3, the token guard, S3Gen. `draws`
        serves both stages (default: a `Draws(seed, device)` each).
        Returns (1, T), with the token count when asked."""
        conds = conditionals.to(self.device)
        if exaggeration is not None:
            conds = conds.replace_emotion(exaggeration)
        info: dict = {}
        t0 = time.time()
        speech_tokens = self._run_t3(
            text, conds, temperature=temperature, cfg_weight=cfg_weight,
            repetition_penalty=repetition_penalty, min_p=min_p, top_p=top_p,
            max_new_tokens=max_new_tokens_override or 1000, seed=seed, draws=draws,
            info=info)
        t3_s = time.time() - t0
        self._guard_tokens(speech_tokens)
        t0 = time.time()
        wav = self._run_s3gen(speech_tokens, conds.gen, seed=seed, draws=draws)[None, :]
        self._record_perf(t3_s, time.time() - t0, speech_tokens.size, wav.size,
                          info["decode_steps"])
        if return_token_count:
            return wav, int(speech_tokens.size)
        return wav

    def chunk_text(self, text: str, target_chars: int = 400,
                   max_chars: int = 600) -> List[ChunkInfo]:
        """Sanitise, then smart-chunk each part between story breaks on its
        own: a break never lands inside a chunk, and the chunk before it is
        marked (has_story_break, paragraph_break_after) for the stitcher's
        pause. Ids run over the whole text."""
        sanitized = self.text_sanitizer.deep_clean(text)
        segments = [s for s in sanitized.split(STORY_BREAK_TOKEN) if s.strip()]
        chunks: List[ChunkInfo] = []
        for si, segment in enumerate(segments):
            part = self.smart_chunker.smart_chunk(segment, target_chars, max_chars)
            if not part:
                continue
            if chunks:
                part[0].is_first_chunk = False
            if si < len(segments) - 1:
                part[-1].has_story_break = True
                part[-1].paragraph_break_after = True
            part[-1].is_last_chunk = False
            for ch in part:
                ch.id = len(chunks)
                chunks.append(ch)
        if chunks:
            chunks[-1].is_last_chunk = True
        return chunks

    def _job_settings(self, adaptive_voice_param_blend: float):
        """(blend, max attempts, fail on a bad chunk) of a job: the forced
        blend of the experiment config wins; CHATTERBOX_CHUNK_REGEN_ATTEMPTS
        (4) and CHATTERBOX_FAIL_ON_BAD_CHUNK (off) are read at call time."""
        blend = self.experiment_config.get("force_adaptive_blend")
        if blend is None:
            blend = adaptive_voice_param_blend
        return (blend, int(os.getenv("CHATTERBOX_CHUNK_REGEN_ATTEMPTS", "4")),
                _env_bool("CHATTERBOX_FAIL_ON_BAD_CHUNK", False))

    def generate_chunks(self, chunk_infos: List[ChunkInfo],
                        voice_profile_path: Optional[str] = None,
                        saved_voice_path: Optional[str] = None,
                        audio_prompt_path: Optional[str] = None,
                        exaggeration=0.5, cfg_weight=0.6, temperature=0.7,
                        adaptive_voice_param_blend: float = 0.2,
                        max_new_tokens: int = 1000, seed: int = 0,
                        make_draws=None) -> Tuple[List[np.ndarray], Dict[str, Any]]:
        """Every chunk of one story with the voice named by the paths (the
        conditional cache). Per-chunk adaptive parameters; first attempts
        of a story of more than one chunk in one lock-step `generate_batch`
        (CHATTERBOX_BATCH_CHUNKS=0: one by one); a take that fails a gate
        goes through the retry pyramid. Returns (segments, stats).

        make_draws: draw-source factory, called with `seed` for the pooled
        pass (generate_batch's rule) and with seed + 1000 * attempt +
        chunk id for each retry (default `Draws(s, device)`)."""
        conds = self._get_or_prepare_conditionals(
            voice_profile_path, saved_voice_path, audio_prompt_path, exaggeration)
        base = dict(exaggeration=exaggeration, cfg_weight=cfg_weight,
                    temperature=temperature, repetition_penalty=1.2, min_p=0.05, top_p=1.0)
        blend, max_attempts, fail_on_bad = self._job_settings(adaptive_voice_param_blend)
        self._perf_acc = self._fresh_perf_acc()
        per_chunk = self._adaptive_chunk_params(chunk_infos, base, blend)
        first: Dict[int, np.ndarray] = {}
        if len(chunk_infos) > 1 and os.getenv("CHATTERBOX_BATCH_CHUNKS", "1") != "0":
            first = self._batched_first_pass([c.text for c in chunk_infos], per_chunk, conds,
                                             max_new_tokens, seed, make_draws)
        segments: List[np.ndarray] = []
        stats = {"chunks": [], "regenerations": 0, "batched_first_pass": bool(first)}
        t_start = time.time()
        for idx, info in enumerate(chunk_infos):
            wav, attempts = self._accept_or_retry(
                info, per_chunk[idx], first.get(idx), conds, max_attempts, fail_on_bad,
                seed, max_new_tokens, make_draws)
            stats["regenerations"] += attempts - 1
            stats["chunks"].append({"id": info.id, "attempts": attempts,
                                    "samples": int(wav.size), "params": per_chunk[idx]})
            segments.append(wav)
        stats["generation_time_s"] = time.time() - t_start
        stats["perf"] = self._perf_acc_snapshot()
        return segments, stats

    def _adaptive_chunk_params(self, chunk_infos: List[ChunkInfo], base: Dict[str, float],
                               blend: float) -> List[Dict[str, float]]:
        """Per-chunk sampling parameters: the job's base blended with the
        AdaptiveParameterManager's profile of the chunk."""
        per_chunk: List[Dict[str, float]] = []
        for info in chunk_infos:
            params = dict(base)
            if self.experiment_config.get("enable_adaptive_voice_params", True):
                adaptive = self.param_manager.get_adaptive_parameters(info)
                for k in ("temperature", "exaggeration", "cfg_weight",
                          "repetition_penalty", "min_p", "top_p"):
                    params[k] = (1 - blend) * base.get(k, adaptive[k]) + blend * adaptive[k]
            per_chunk.append(params)
        return per_chunk

    def _batched_first_pass(self, texts: List[str], per_chunk: List[Dict[str, float]],
                            conds, max_new_tokens: int, seed: int,
                            make_draws=None) -> Dict[int, np.ndarray]:
        """One lock-step `generate_batch` over all pending chunks, each row
        with its own parameters; `conds` is one Conditionals or one per row.
        Returns {row: wav}, or {} when the voices cannot share a batch
        (VoiceBatchError: the caller runs the chunks one by one).

        CHATTERBOX_CONTINUOUS=1 (read at call time) runs the pass on the
        slot-refill engine (`_continuous_first_pass`) when there is more
        than one chunk; the lock-step batch serves when the engine refuses
        a chunk before decoding (`ValueError` from its submit)."""
        if _env_bool("CHATTERBOX_CONTINUOUS", False) and len(texts) > 1:
            first = self._continuous_first_pass(texts, per_chunk, conds, max_new_tokens,
                                                seed, make_draws)
            if first is not None:
                return first
        try:
            wavs = self.generate_batch(
                texts,
                temperature=np.array([p["temperature"] for p in per_chunk]),
                cfg_weight=np.array([p["cfg_weight"] for p in per_chunk]),
                repetition_penalty=np.array([p["repetition_penalty"] for p in per_chunk]),
                min_p=np.array([p["min_p"] for p in per_chunk]),
                top_p=np.array([p["top_p"] for p in per_chunk]),
                exaggeration=np.array([p["exaggeration"] for p in per_chunk]),
                max_new_tokens=max_new_tokens, seed=seed, conds=conds,
                make_draws=make_draws)
        except VoiceBatchError:
            logger.exception("the chunks' voices cannot share a batch; one by one")
            return {}
        return dict(enumerate(wavs))

    def _continuous_first_pass(self, texts: List[str], per_chunk: List[Dict[str, float]],
                               conds, max_new_tokens: int, seed: int,
                               make_draws=None) -> Optional[Dict[int, np.ndarray]]:
        """The pooled first pass on the slot-refill engine
        (serving/continuous.py): rows decode at their own depths and freed
        slots take the rest of the queue. Row r samples from make_draws(seed
        + r). Returns {row: wav} (a row whose decode came out too short is
        missing: the caller's retry pyramid runs it), or None when the
        engine refuses a chunk at submit (a cond without prompt tokens, a
        text over the bucket), before any decode. Every other error
        propagates (the JAX package falls back on any)."""
        from .models.t3_engine import engine_geometry
        from .serving.continuous import ContinuousServer
        conds_list = (list(conds) if isinstance(conds, (list, tuple))
                      else [conds] * len(texts))
        tok_lens = [len(self.tokenizer.text_to_tokens(t)[0]) + 2 for t in texts]
        bucket = t3_mod._bucket(max(tok_lens))
        cap = min(max_new_tokens, 1000)
        _, capacity = engine_geometry(self.cfg.t3, bucket,
                                      2 + self.cfg.t3.perceiver_num_queries, cap)
        slots = min(len(texts), 16, t3_mod.max_decode_utterances(
            capacity, cfg=self.cfg.t3, dtype=self.dtype,
            free_bytes=t3_mod.free_device_bytes(self.device)))
        if self.mesh is not None:
            slots = -(-slots // self.mesh.dp) * self.mesh.dp      # the engine's slots over dp
        srv = ContinuousServer(
            self, slots=slots, text_bucket=bucket, max_new_tokens=cap, block=64,
            vocode_batch=max(4, slots // 2),
            use_top_p=bool(np.any([p["top_p"] < 1.0 for p in per_chunk])), retries=0,
            make_draws=make_draws)
        rid_to_row = {}
        try:
            for row, (text, p, c) in enumerate(zip(texts, per_chunk, conds_list)):
                rid = srv.submit(text, c, temperature=p["temperature"],
                                 cfg_weight=p["cfg_weight"],
                                 repetition_penalty=p["repetition_penalty"], min_p=p["min_p"],
                                 top_p=p["top_p"], exaggeration=p.get("exaggeration"),
                                 seed=seed + row, max_new_tokens=max_new_tokens)
                rid_to_row[rid] = row
        except ValueError:
            logger.exception("the continuous engine refused a chunk; lock-step batch")
            return None
        return {rid_to_row[rid]: w for rid, w in srv.drain().items()}

    def _accept_or_retry(self, info: ChunkInfo, params: Dict[str, float],
                         wav0: Optional[np.ndarray], conds: Conditionals,
                         max_attempts: int, fail_on_bad: bool, seed: int,
                         max_new_tokens: int, make_draws=None) -> Tuple[np.ndarray, int]:
        """Accept the pooled take when it has at least the token guard's 8
        tokens (in samples) and passes the gates, else run the retry
        pyramid. Returns (wav, attempts), the pooled take counted."""
        min_samples = 8 * 2 * 480
        if (wav0 is not None and wav0.size >= min_samples
                and self._chunk_gates_ok(wav0.reshape(-1), info)[0]):
            return wav0.reshape(-1), 1
        wav, attempts = self._generate_single_chunk_with_quality(
            info, conds, params, max_attempts, fail_on_bad, seed, max_new_tokens, make_draws)
        if wav0 is not None:
            attempts += 1
        return wav, attempts

    def generate_chunks_multi(self, jobs_chunks: List[List[ChunkInfo]],
                              jobs_conds: List[Conditionals],
                              jobs_params: Optional[List[Dict[str, float]]] = None,
                              adaptive_voice_param_blend: float = 0.2,
                              max_new_tokens: int = 1000, seed: int = 0,
                              make_draws=None
                              ) -> List[Tuple[List[np.ndarray], Dict[str, Any]]]:
        """The chunks of many stories, each with its own voice, in one
        pooled lock-step `generate_batch` (per-row voices and parameters),
        with the gates and the retry pyramid per job. Returns [(segments,
        stats)] per job; the stage totals and the wall time are the
        pool's. make_draws: as in generate_chunks."""
        if len(jobs_chunks) != len(jobs_conds) or (
                jobs_params is not None and len(jobs_params) != len(jobs_chunks)):
            raise ValueError("generate_chunks_multi: one voice (and parameter set) per job")
        blend, max_attempts, fail_on_bad = self._job_settings(adaptive_voice_param_blend)
        self._perf_acc = self._fresh_perf_acc()
        defaults = dict(exaggeration=0.5, cfg_weight=0.6, temperature=0.7,
                        repetition_penalty=1.2, min_p=0.05, top_p=1.0)
        rows: List[Tuple[int, ChunkInfo, Dict[str, float]]] = []
        for j, chunks in enumerate(jobs_chunks):
            base = dict(defaults)
            if jobs_params and jobs_params[j]:
                base.update({k: v for k, v in jobs_params[j].items() if v is not None})
            for info, params in zip(chunks, self._adaptive_chunk_params(chunks, base, blend)):
                rows.append((j, info, params))
        first: Dict[int, np.ndarray] = {}
        if len(rows) > 1 and os.getenv("CHATTERBOX_BATCH_CHUNKS", "1") != "0":
            first = self._batched_first_pass(
                [r[1].text for r in rows], [r[2] for r in rows],
                [jobs_conds[r[0]] for r in rows], max_new_tokens, seed, make_draws)
        out: List[Tuple[List[np.ndarray], Dict[str, Any]]] = []
        t_start = time.time()
        row_idx = 0
        for j, chunks in enumerate(jobs_chunks):
            segments: List[np.ndarray] = []
            stats: Dict[str, Any] = {"chunks": [], "regenerations": 0,
                                     "batched_first_pass": bool(first),
                                     "pooled_jobs": len(jobs_chunks), "pooled_rows": len(rows)}
            for info in chunks:
                params = rows[row_idx][2]
                wav, attempts = self._accept_or_retry(
                    info, params, first.get(row_idx), jobs_conds[j], max_attempts,
                    fail_on_bad, seed, max_new_tokens, make_draws)
                row_idx += 1
                stats["regenerations"] += attempts - 1
                stats["chunks"].append({"id": info.id, "attempts": attempts,
                                        "samples": int(wav.size), "params": params})
                segments.append(wav)
            out.append((segments, stats))
        batch_perf = self._perf_acc_snapshot()
        wall = time.time() - t_start
        for _, stats in out:
            stats["generation_time_s"] = wall
            stats["perf"] = batch_perf
        return out

    def _chunk_gates_ok(self, flat: np.ndarray, info: ChunkInfo) -> Tuple[bool, str]:
        """The chunk gates of the pooled take and of each retry: (ok,
        reason), reason "silence" (peak < 1e-6 and rms < 1e-7) or "qa" (the
        quality analyzer asks for a regeneration; only with
        CHATTERBOX_ENABLE_QUALITY_ANALYSIS outside prod mode)."""
        if self.experiment_config.get("enable_silence_gate", True):
            peak = float(np.abs(flat).max()) if flat.size else 0.0
            rms = float(np.sqrt(np.mean(np.square(flat)))) if flat.size else 0.0
            if peak < 1e-6 and rms < 1e-7:
                return False, "silence"
        if self.enable_quality_analysis and self.experiment_config.get("enable_qa_regen", True):
            q = self.quality_analyzer.analyze_chunk_quality(flat, self.sr, info)
            if q.should_regenerate:
                return False, "qa"
        return True, ""

    def _generate_single_chunk_with_quality(self, info: ChunkInfo, conds: Conditionals,
                                            params: Dict[str, float], max_attempts: int,
                                            fail_on_bad: bool, seed: int,
                                            max_new_tokens: int = 1000,
                                            make_draws=None) -> Tuple[np.ndarray, int]:
        """The retry pyramid: attempt a runs with the parameters drifted by
        a (temperature -0.08 a, cfg_weight +0.08 a, exaggeration -0.05 a,
        clamped) and seed + 1000 a + chunk id. A token-guard failure or a
        silent take retries; a QA rejection retries while attempts remain
        and is kept on the last. When every attempt failed, half a second
        of silence stands in (CHATTERBOX_FAIL_ON_BAD_CHUNK=1: raise).
        Returns (wav, attempts)."""
        drift_on = self.experiment_config.get("enable_retry_param_drift", True)
        last_wav = None
        for attempt in range(max_attempts):
            p = dict(params)
            if drift_on and attempt > 0:
                p["temperature"] = max(0.5, p["temperature"] - 0.08 * attempt)
                p["cfg_weight"] = min(0.8, p["cfg_weight"] + 0.08 * attempt)
                p["exaggeration"] = max(0.1, p["exaggeration"] - 0.05 * attempt)
            s = seed + attempt * 1000 + info.id
            try:
                wav = self._generate_with_prepared_conditionals(
                    info.text, conds, exaggeration=p["exaggeration"],
                    repetition_penalty=p["repetition_penalty"], min_p=p["min_p"],
                    top_p=p["top_p"], cfg_weight=p["cfg_weight"],
                    temperature=p["temperature"], max_new_tokens_override=max_new_tokens,
                    seed=s, draws=make_draws(s) if make_draws is not None else None)
            except TokenGuardError as e:
                logger.warning("chunk %d attempt %d failed: %s", info.id, attempt, e)
                continue
            flat = wav.reshape(-1)
            last_wav = flat
            ok, reason = self._chunk_gates_ok(flat, info)
            if not ok:
                if reason == "silence":
                    logger.warning("chunk %d attempt %d: silent output", info.id, attempt)
                    continue
                if attempt < max_attempts - 1:
                    logger.info("chunk %d QA regen", info.id)
                    continue
            return flat, attempt + 1
        if last_wav is None:
            if fail_on_bad:
                raise RuntimeError(f"chunk {info.id} failed after {max_attempts} attempts")
            last_wav = np.zeros(self.sr // 2, np.float32)
        return last_wav, max_attempts

    def stitch_and_normalize(self, segments: List[np.ndarray], chunk_infos: List[ChunkInfo],
                             output_path: Optional[str] = None):
        """(wav, sample rate, seconds): fades, smart pauses, peak
        normalisation to -0.5 dBFS; written to `output_path` when given."""
        return self.advanced_stitcher.advanced_stitch(segments, chunk_infos, output_path)

    def cleanup_chunks(self, paths: List[str]):
        for p in paths:
            try:
                os.unlink(p)
            except OSError:
                pass

    def generate_long_text(self, text: str, voice_profile_path: Optional[str] = None,
                           saved_voice_path: Optional[str] = None,
                           audio_prompt_path: Optional[str] = None,
                           exaggeration=0.5, cfg_weight=0.6, temperature=0.7,
                           target_chars: int = 400, max_chars: int = 600,
                           output_path: Optional[str] = None, seed: int = 0,
                           max_new_tokens: int = 1000, make_draws=None
                           ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """The story path: chunk, generate (generate_chunks), stitch,
        watermark. Returns (wav (1, T), metadata with the chunk stats and
        the job's stage totals under "perf")."""
        t0 = time.time()
        chunks = self.chunk_text(text, target_chars, max_chars)
        if not chunks:
            raise ValueError("no synthesisable text after sanitisation")
        segments, gen_stats = self.generate_chunks(
            chunks, voice_profile_path, saved_voice_path, audio_prompt_path,
            exaggeration, cfg_weight, temperature, max_new_tokens=max_new_tokens, seed=seed,
            make_draws=make_draws)
        wav, sr, duration = self.stitch_and_normalize(segments, chunks, output_path)
        wav = self.watermarker.apply_watermark(wav, sample_rate=sr)
        total = time.time() - t0
        metadata = {
            "runtime_version": CHATTERBOX_RUNTIME_VERSION,
            "num_chunks": len(chunks),
            "duration_s": duration,
            "generation_time_s": total,
            "audio_ratio": duration / total if total > 0 else 0.0,
            "cache_stats": self.get_conditional_cache_stats(),
            "chunk_stats": gen_stats,
            "perf": gen_stats.get("perf", {}),
        }
        return wav[None, :], metadata

    def generate_long_text_batch(self, texts: List[str],
                                 voice_profile_paths: Optional[List[str]] = None,
                                 conds_list: Optional[List[Conditionals]] = None,
                                 exaggeration=0.5, cfg_weight=0.6, temperature=0.7,
                                 target_chars: int = 400, max_chars: int = 600,
                                 seed: int = 0, max_new_tokens: int = 1000,
                                 pause_scales: Optional[List[float]] = None,
                                 make_draws=None
                                 ) -> List[Tuple[Optional[np.ndarray], Dict[str, Any]]]:
        """Many stories, each with its own voice (a profile path or
        Conditionals), through one pooled decode (generate_chunks_multi),
        then stitched and watermarked one by one with each job's pause
        scale (the stitcher's own is restored afterwards). Sampling
        parameters and pause scales are one value or one per job. Entry i
        is (wav (1, T), metadata), or (None, {"error": ...}) when job i's
        text or voice file failed before generation; other errors
        propagate."""
        n = len(texts)
        if conds_list is None:
            if voice_profile_paths is None or len(voice_profile_paths) != n:
                raise ValueError("generate_long_text_batch: one voice profile path per text")
        elif len(conds_list) != n:
            raise ValueError("generate_long_text_batch: one Conditionals per text")

        def per_job(v, default):
            if v is None:
                v = default
            if isinstance(v, (list, tuple, np.ndarray)):
                if len(v) != n:
                    raise ValueError(f"generate_long_text_batch: {len(v)} values for {n} jobs")
                return [float(x) for x in v]
            return [float(v)] * n

        exg = per_job(exaggeration, 0.5)
        cfgw = per_job(cfg_weight, 0.6)
        temp = per_job(temperature, 0.7)
        pauses = per_job(pause_scales, self.advanced_stitcher.global_pause_factor)
        t0 = time.time()
        errors: Dict[int, str] = {}
        jobs_chunks: List[List[ChunkInfo]] = []
        jobs_conds: List[Conditionals] = []
        jobs_params: List[Dict[str, float]] = []
        live: List[int] = []
        for i in range(n):
            try:
                chunks = self.chunk_text(texts[i], target_chars, max_chars)
                if not chunks:
                    raise ValueError("no synthesisable text after sanitisation")
                conds = (conds_list[i] if conds_list is not None
                         else self._get_or_prepare_conditionals(
                             voice_profile_path=voice_profile_paths[i], exaggeration=exg[i]))
            except _JOB_ERRORS as e:
                logger.exception("batch job %d failed before generation", i)
                errors[i] = str(e)
                continue
            jobs_chunks.append(chunks)
            jobs_conds.append(conds)
            jobs_params.append(dict(exaggeration=exg[i], cfg_weight=cfgw[i],
                                    temperature=temp[i]))
            live.append(i)
        gen = (self.generate_chunks_multi(jobs_chunks, jobs_conds, jobs_params,
                                          max_new_tokens=max_new_tokens, seed=seed,
                                          make_draws=make_draws)
               if jobs_chunks else [])
        results: List[Tuple[Optional[np.ndarray], Dict[str, Any]]] = [
            (None, {"error": errors.get(i, "job skipped")}) for i in range(n)]
        prev_pause = self.advanced_stitcher.global_pause_factor
        try:
            for k, i in enumerate(live):
                segments, gen_stats = gen[k]
                self.advanced_stitcher.global_pause_factor = pauses[i]
                wav, sr, duration = self.stitch_and_normalize(segments, jobs_chunks[k])
                wav = self.watermarker.apply_watermark(wav, sample_rate=sr)
                total = time.time() - t0
                results[i] = (wav[None, :], {
                    "runtime_version": CHATTERBOX_RUNTIME_VERSION,
                    "num_chunks": len(jobs_chunks[k]),
                    "duration_s": duration,
                    "generation_time_s": total,
                    "audio_ratio": duration / total if total > 0 else 0.0,
                    "cache_stats": self.get_conditional_cache_stats(),
                    "chunk_stats": gen_stats,
                    "perf": gen_stats.get("perf", {}),
                    "batched_jobs": len(live),
                })
        finally:
            self.advanced_stitcher.global_pause_factor = prev_pause
        return results

    def generate_long_text_with_saved_voice(self, text, saved_voice_path, audio_prompt_path,
                                            **kw):
        return self.generate_long_text(text, saved_voice_path=saved_voice_path,
                                       audio_prompt_path=audio_prompt_path, **kw)

    def generate_long_text_with_audio_prompt(self, text, audio_prompt_path, **kw):
        return self.generate_long_text(text, audio_prompt_path=audio_prompt_path, **kw)

    def generate_chunks_with_saved_voice(self, chunk_infos, saved_voice_path,
                                         audio_prompt_path, **kw):
        return self.generate_chunks(chunk_infos, saved_voice_path=saved_voice_path,
                                    audio_prompt_path=audio_prompt_path, **kw)

    def generate_chunks_with_audio_prompt(self, chunk_infos, audio_prompt_path, **kw):
        return self.generate_chunks(chunk_infos, audio_prompt_path=audio_prompt_path, **kw)

    def generate_chunks_parallel(self, chunk_infos, **kw):
        """The chunks in parallel: generate_chunks, whose pooled first pass
        is the lock-step batch (the JAX package's alias)."""
        return self.generate_chunks(chunk_infos, **kw)

    # ------------------------------------------------------------------
    # serving jobs
    # ------------------------------------------------------------------

    def upload_to_storage(self, data: bytes, dest_path: str, bucket: Optional[str] = None):
        """R2 upload (serving/storage.py; the local-storage emulation
        without boto3)."""
        from .serving.storage import upload_to_r2
        return upload_to_r2(data, dest_path, bucket)

    def generate_tts_story(self, *args, **kwargs):
        """The full serving job: serving/jobs.py:generate_tts_story."""
        from .serving.jobs import generate_tts_story
        return generate_tts_story(self, *args, **kwargs)


def _build_serving_kernels() -> None:
    """Build (one nvcc each, all started together) and load every kernel a
    request can launch: K1/K1s, K2, K3 and K4. The probes build when run."""
    from .kernels import _build, flash_attention, flash_decode, fused_decode, rel_attention
    entries = {flash_decode: "cbx_flash_decode", rel_attention: "cbx_rel_attention",
               flash_attention: "cbx_flash_attention", fused_decode: "cbx_fused_decode"}
    _build.build_all([m.SOURCE for m in entries])
    for m, entry in entries.items():
        _build.load(m.SOURCE, entry, m._ARGTYPES)
