"""Streaming synthesis, the PyTorch counterpart of
`chatterbox_embed_tpu/streaming.py`: the windowed flow + vocoder tail over a
stream of speech-token blocks.

The JAX package also compiles its first chunk (context, prefill, the first
decode block, the first flow window and the first vocoder window) into one
program (`first_chunk`), to save host round trips to a remote device. In the
port those steps would be the same eager calls as every later block, so
`ChatterboxTTS.stream_generate` feeds every block, the first included,
through WindowedSynth; the chunks are those of the JAX package's
stage-by-stage route.

Draws: one draw source serves a stream. T3 step i takes draws.gumbel(i);
the vocoder windows take draws.stream_phase (one per utterance) and
draws.window_noise(k) for window k (ops/sampling.py:Draws).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .config import SPEECH_VOCAB_SIZE, ChatterboxConfig
from .models import hifigan as hift_mod
from .models import s3gen as s3gen_mod

# Windowed-streaming geometry (the flow's context tokens and the vocoder's
# context mel frames); read once at import, as in the JAX package.
STREAM_CTX_TOKENS = int(os.getenv("CHATTERBOX_STREAM_CTX", "6"))      # C (> pre-lookahead 3)
STREAM_VOC_CTX_MEL = int(os.getenv("CHATTERBOX_STREAM_VOC_CTX", "8"))  # M (covers conv fields)


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
    finish() flushes the final window (lookahead included).
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
