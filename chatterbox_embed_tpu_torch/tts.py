"""ChatterboxTTS, the public text-to-speech pipeline: the PyTorch counterpart
of `chatterbox_embed_tpu/tts.py` for one utterance with prepared
conditionals (the main path: tokenize, T3, S3Gen).

Host code tokenizes, pads to buckets and moves numpy at the edges; T3 and
S3Gen run on `device` with the compute `dtype`.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from chatterbox_embed_tpu.utils import weights as jax_weights

from .conditionals import Conditionals
from .config import S3GEN_SR, ChatterboxConfig
from .models import layers as L
from .models import s3gen as s3gen_mod
from .models import t3 as t3_mod
from .models.tokenizer import EnTokenizer, FallbackTokenizer
from .ops.sampling import Draws
from .weights import from_jax_params, place

_TOKEN_BUCKETS = (128, 256, 512, 1024)


def _bucket_tokens(n: int) -> int:
    for b in _TOKEN_BUCKETS:
        if n <= b:
            return b
    return n


class ChatterboxTTS:
    def __init__(self, t3_params, s3gen_params, tokenizer,
                 conds: Optional[Conditionals] = None,
                 config: ChatterboxConfig = ChatterboxConfig(),
                 dtype=torch.float32, device="cpu"):
        """t3_params / s3gen_params: the port's trees (see weights.py); they
        are placed on `device`, matmul and conv weights in `dtype`."""
        self.sr = S3GEN_SR
        self.cfg = config
        self.dtype = dtype
        self.device = torch.device(device)
        self.t3_params = place(t3_params, self.device, dtype)
        self.s3gen_params = place(s3gen_params, self.device, dtype)
        self.tokenizer = tokenizer
        self.conds = conds.to(self.device) if conds is not None else None
        # the last request's stage timings and counts (_record_perf)
        self.perf: Dict[str, float] = {}

    @classmethod
    def from_random(cls, seed: int = 0, config: ChatterboxConfig = ChatterboxConfig(),
                    tokenizer=None, dtype=torch.float32, device="cpu"):
        """Randomly initialised pipeline, drawn on `device` from `seed`."""
        init = L.Init(seed, device)
        return cls(t3_mod.init(init, config.t3), s3gen_mod.init(init, config.s3gen),
                   tokenizer or FallbackTokenizer(config.t3), conds=None,
                   config=config, dtype=dtype, device=device)

    @classmethod
    def from_local(cls, ckpt_dir, config: ChatterboxConfig = ChatterboxConfig(),
                   dtype=torch.float32, device="cpu"):
        """Load reference checkpoints: t3_cfg.safetensors, s3gen.safetensors,
        tokenizer.json and (if present) conds.pt in `ckpt_dir`. The JAX
        package's numpy converters build its trees, which `from_jax_params`
        turns into the port's."""
        ckpt_dir = Path(ckpt_dir)
        t3_sd = jax_weights.load_safetensors(str(ckpt_dir / "t3_cfg.safetensors"))
        t3_tree = jax_weights.convert_t3(t3_sd, num_layers=config.t3.llama.num_layers)
        s3_sd = jax_weights.load_safetensors(str(ckpt_dir / "s3gen.safetensors"))
        s3_tree = jax_weights.convert_s3gen(s3_sd, cfg=config.s3gen)
        state = from_jax_params(t3_tree, s3_tree, config)
        tokenizer = EnTokenizer(str(ckpt_dir / "tokenizer.json"))
        conds = None
        if (ckpt_dir / "conds.pt").exists():
            conds = Conditionals.load(str(ckpt_dir / "conds.pt"))
        return cls(state["t3"], state["s3gen"], tokenizer, conds, config, dtype, device)

    # ------------------------------------------------------------------
    # generation
    # ------------------------------------------------------------------

    def _record_perf(self, t3_s: float, s3gen_s: float, tokens: int,
                     samples: int, decode_steps: int) -> Dict[str, float]:
        """The last request's stage timings (host clock around work that
        ends in a device->host copy) and counts."""
        total = t3_s + s3gen_s
        audio_s = samples / float(self.sr)
        self.perf = {
            "t3_s": t3_s, "s3gen_s": s3gen_s, "total_s": total,
            "speech_tokens": int(tokens), "decode_steps": int(decode_steps),
            "tokens_per_s": tokens / t3_s if t3_s > 0 else 0.0,
            "audio_s": audio_s,
            "rtf": total / audio_s if audio_s > 0 else 0.0,
            "batch": 1,
        }
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
            seed=seed, draws=draws, cfg=self.cfg.t3, dtype=self.dtype,
            device=self.device, info=info)
        # generate stops at (and includes) the first EOS; drop it and every
        # other non-speech id
        return s3gen_mod.drop_invalid_tokens(speech)

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
        if speech_tokens.size == 0:
            raise RuntimeError("T3 produced empty speech token sequence (likely early EOS)")
        if speech_tokens.size < 8:
            raise RuntimeError(
                f"T3 produced too few speech tokens after filtering ({speech_tokens.size} < 8)")

    def generate(self, text, repetition_penalty=1.2, min_p=0.05, top_p=1.0,
                 cfg_weight=0.3, temperature=0.6, max_new_tokens=1000, seed=0,
                 draws=None) -> np.ndarray:
        """Single-utterance TTS with the prepared conditionals. Returns (1, T).

        draws: optional draw source for the T3 Gumbel noise and the HiFT
        phases and noise; by default each stage draws from its own
        `Draws(seed, device)`."""
        if self.conds is None:
            raise RuntimeError("Conditionals are not prepared: pass conds= (or a "
                               "conds.pt through from_local); conditioning from "
                               "reference audio is not ported yet")
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
        return wav[None, :]

