"""S3Gen: speech tokens -> mel (conformer + CFM) -> waveform (HiFT), the
PyTorch counterpart of `chatterbox_embed_tpu/models/s3gen.py`: one shared
voice prompt, or ragged per-row prompts for multi-voice batches, the
windowed flow of streaming (`flow_to_mel_window`), the voice-reference
embedding path (`embed_ref`) and the `.npy` VoiceProfile format.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import S3_SR, S3GEN_SR, SPEECH_VOCAB_SIZE, S3GenConfig
from ..device import constant, lap
from ..ops import mel as mel_ops
from ..ops import resample as resample_ops
from ..utils import profiling
from . import layers as L
from . import cfm, conformer, flow_decoder, hifigan, s3tokenizer, xvector


def init(init: L.Init, cfg: S3GenConfig = S3GenConfig()):
    """The flow and vocoder parameters, then the conditioning encoders (the
    CAMPPlus speaker encoder and the S3 speech tokenizer)."""
    flow = {
        "input_embedding": L.embedding_init(init, cfg.flow.vocab_size, cfg.flow.input_size,
                                            std=0.02),
        "spk_embed_affine": L.linear_init(init, cfg.flow.spk_embed_dim, cfg.flow.output_size),
        "encoder": conformer.init(init, cfg.flow.encoder),
        "encoder_proj": L.linear_init(init, cfg.flow.encoder.output_size, cfg.flow.output_size),
        "decoder": flow_decoder.init(init, cfg.flow.decoder),
    }
    return {"flow": flow, "hift": hifigan.init(init, cfg.hift),
            "speaker_encoder": xvector.init(init, cfg.campplus),
            "tokenizer": s3tokenizer.init(init, cfg.tokenizer)}


@torch.no_grad()
def flow_to_mel(params, tokens: torch.Tensor, token_len: torch.Tensor,
                prompt_tokens: torch.Tensor, prompt_feat: torch.Tensor,
                embedding: torch.Tensor, cfg: S3GenConfig = S3GenConfig(),
                dtype=torch.float32, prompt_len: torch.Tensor | None = None,
                cache_every=None, cfg_steps=None):
    """CausalMaskedDiffWithXvec inference.

      tokens:        (B, T_tok) target speech tokens
      token_len:     (B,) valid lengths of [prompt; target]
      prompt_tokens: (B, T_p) reference speech tokens
      prompt_feat:   (B, T_mel_p, 80) reference mel (2 frames per token)
      embedding:     (B, 192) x-vector
      prompt_len:    (B,) valid prompt lengths for multi-voice rows, whose
                     prompts are padded to a common T_p; None keeps the
                     shared-prompt layout (every row's prompt is T_p long)
      cache_every, cfg_steps: the CFM solver's options (cfm.solve_euler)
    Returns (B, 2*T_tok, 80) fp32 mel of the generated part.
    """
    fl = params["flow"]
    emb = embedding / torch.linalg.norm(embedding, dim=-1, keepdim=True)
    spks = L.linear(fl["spk_embed_affine"], emb.float())
    r = cfg.flow.token_mel_ratio

    if prompt_len is None:
        full = torch.cat([prompt_tokens, tokens], dim=1).long()
    else:
        # ragged prompts: row b is [prompt_b(:p_b); generated_b; pad], a
        # gather that keeps each row contiguous, so the conformer positions
        # equal a solo run of that row
        p_max, t_gen = prompt_tokens.shape[1], tokens.shape[1]
        j = torch.arange(p_max + t_gen, device=tokens.device)[None]
        pl = prompt_len.long()[:, None]
        pidx = j.clamp(0, p_max - 1).expand(prompt_tokens.shape[0], -1)
        gidx = (j - pl).clamp(0, t_gen - 1)
        full = torch.where(j < pl, prompt_tokens.long().gather(1, pidx),
                           tokens.long().gather(1, gidx))
    t = full.shape[1]
    mask = torch.arange(t, device=full.device)[None] < token_len[:, None]
    x = L.embedding(fl["input_embedding"], full.clamp_min(0))
    x = x * mask[..., None].to(x.dtype)

    with profiling.span("s3gen.encoder"):
        h = conformer.forward(fl["encoder"], x, token_len, cfg.flow.encoder, dtype)
        h = L.linear(fl["encoder_proj"], h.float())
    mel_len1 = prompt_feat.shape[1]

    conds = torch.zeros((h.shape[0], h.shape[1], cfg.flow.output_size),
                        dtype=h.dtype, device=h.device)
    if prompt_len is None:
        conds[:, :mel_len1] = prompt_feat.to(h.dtype)
    else:
        # per-row prompt frames: positions m < 2 * p_b carry the reference mel
        m = torch.arange(mel_len1, device=h.device)[None, :, None]
        conds[:, :mel_len1] = torch.where(m < r * prompt_len.long()[:, None, None],
                                          prompt_feat.to(h.dtype), 0.0)

    # mel-rate validity mask: bucket padding must not leak into valid frames
    mel_valid = r * token_len
    mel_mask = (torch.arange(h.shape[1], device=h.device)[None, :]
                < mel_valid[:, None])[..., None].to(h.dtype)

    with profiling.span("s3gen.cfm"):
        mel = cfm.generate_mel(fl["decoder"], h, spks, conds, mask=mel_mask,
                               cfm=cfg.flow.cfm, dec_cfg=cfg.flow.decoder, dtype=dtype,
                               cache_every=cache_every, cfg_steps=cfg_steps)
    if prompt_len is None:
        return mel[:, mel_len1:]
    # realign: row b's generated frames start at frame 2 * p_b
    m2 = (torch.arange(r * tokens.shape[1], device=mel.device)[None]
          + r * prompt_len.long()[:, None]).clamp(0, mel.shape[1] - 1)
    return mel.gather(1, m2[..., None].expand(-1, -1, mel.shape[2]))


@torch.no_grad()
def flow_to_mel_window(params, tokens: torch.Tensor, vlen: torch.Tensor,
                       prompt_tokens: torch.Tensor, prompt_feat: torch.Tensor,
                       embedding: torch.Tensor, mu_pin: torch.Tensor, pin_frames: int,
                       noise_off: int, finalize: bool = False,
                       cfg: S3GenConfig = S3GenConfig(), dtype=torch.float32):
    """The streaming flow over one window (the JAX package's
    flow_to_mel_window): the window holds the last `vlen` tokens
    left-aligned in tokens (B, W), [C context tokens; new tokens], after the
    prompt. Continuity across windows:
      - the prompt rides along in every window;
      - `mu_pin` (B, PIN, 80) overwrites the first `pin_frames` generated mu
        frames with the previous window's values;
      - the CFM noise is taken at absolute frame positions (noise_off is the
        window's first generated frame in the utterance).
    Without `finalize` the last pre_lookahead tokens' frames stay masked.
    Returns (mel (B, 2*W, 80) of the generated region, mu_tail (B, PIN, 80)
    to pin the next window)."""
    fl = params["flow"]
    r = cfg.flow.token_mel_ratio
    look = cfg.flow.pre_lookahead_len
    emb = embedding / torch.linalg.norm(embedding, dim=-1, keepdim=True)
    spks = L.linear(fl["spk_embed_affine"], emb.float())
    full = torch.cat([prompt_tokens, tokens], dim=1).long()
    t = full.shape[1]
    token_len = prompt_tokens.shape[1] + vlen
    mask = torch.arange(t, device=full.device)[None] < token_len[:, None]
    x = L.embedding(fl["input_embedding"], full.clamp_min(0))
    x = x * mask[..., None].to(x.dtype)
    h = conformer.forward(fl["encoder"], x, token_len, cfg.flow.encoder, dtype)
    mel_len1 = prompt_feat.shape[1]
    mu = L.linear(fl["encoder_proj"], h.float())

    # previously emitted conditioning pinned over the context region
    pin_max = mu_pin.shape[1]
    gen_idx = torch.arange(mu.shape[1], device=mu.device) - mel_len1
    pin_mask = (gen_idx >= 0) & (gen_idx < pin_frames)
    pick = gen_idx.clamp(0, pin_max - 1)
    mu = torch.where(pin_mask[None, :, None], mu_pin[:, pick].to(mu.dtype), mu)

    conds = torch.zeros_like(mu)
    conds[:, :mel_len1] = prompt_feat.to(mu.dtype)
    mel_valid = r * token_len
    if not finalize:
        mel_valid = mel_valid - r * look
    mel_mask = (torch.arange(mu.shape[1], device=mu.device)[None, :]
                < mel_valid[:, None])[..., None].to(mu.dtype)
    mel = cfm.generate_mel_stream(fl["decoder"], mu, spks, conds, mel_mask,
                                  prompt_frames=mel_len1, noise_off=noise_off,
                                  cfm=cfg.flow.cfm, dec_cfg=cfg.flow.decoder, dtype=dtype)
    # mu frames of tokens [vlen - C, vlen - C + PIN / r), C = PIN / r + look;
    # the start clamped into mu, as JAX's dynamic_slice clamps it, and taken
    # on the device (vlen may be a count the device computed)
    tail = (mel_len1 + r * vlen.reshape(-1)[:1].long() - pin_max - r * look).clamp(
        0, mu.shape[1] - pin_max)
    rows = tail + torch.arange(pin_max, device=mu.device)
    return mel[:, mel_len1:], mu.index_select(1, rows)


def trim_fade(sr: int = S3GEN_SR) -> np.ndarray:
    """20 ms silence + 20 ms cosine fade-in."""
    n = sr // 50
    fade = np.zeros(2 * n, np.float32)
    fade[n:] = (np.cos(np.linspace(np.pi, 0.0, n)) + 1.0) / 2.0
    return fade


def trim_fade_on(device, sr: int = S3GEN_SR) -> torch.Tensor:
    """trim_fade(sr) on `device`, copied there once."""
    return constant(("trim_fade", sr), device, lambda: trim_fade(sr))


@torch.no_grad()
def token_to_wav(params, tokens, token_len, prompt_tokens, prompt_feat,
                 embedding, draws, cfg: S3GenConfig = S3GenConfig(),
                 dtype=torch.float32, prompt_len=None, cache_every=None,
                 cfg_steps=None):
    """tokens -> (B, T_wav) fp32 wav with the trim fade applied; `draws`
    feeds the HiFT source. prompt_len, cache_every and cfg_steps are
    flow_to_mel's."""
    mel = flow_to_mel(params, tokens, token_len, prompt_tokens, prompt_feat,
                      embedding, cfg, dtype, prompt_len, cache_every, cfg_steps)
    with profiling.span("s3gen.hift"):
        wav, _src = hifigan.inference(params["hift"], mel, draws, cfg.hift, dtype)
    fade = trim_fade_on(wav.device)
    wav[:, : fade.shape[0]] *= fade
    return wav


# ---------------------------------------------------------------------------
# reference embedding (host-orchestrated, device-computed)
# ---------------------------------------------------------------------------

def _param_device(params) -> torch.device:
    return params["flow"]["input_embedding"]["w"].device


def _resampled(wav: torch.Tensor, sr: int, new_sr: int) -> torch.Tensor:
    return wav if sr == new_sr else resample_ops.resample(wav, sr, new_sr)


@torch.no_grad()
def embed_ref(params, ref_wav: np.ndarray, ref_sr: int,
              cfg: S3GenConfig = S3GenConfig(), timings: Optional[dict] = None
              ) -> Dict[str, np.ndarray]:
    """Build the reference dict for voice cloning: the prompt mel at 24 kHz,
    the CAMPPlus x-vector and the prompt speech tokens, all in fp32 on the
    device of `params`. Returns numpy arrays with the shapes and dtypes of
    the reference's ref_dict, so the `.npy` VoiceProfile format round-trips.

    timings: optional dict that receives the seconds of each part (host
    clock after a device synchronise): resample_s, mel_s, campplus_s,
    tokenizer_s."""
    dev = _param_device(params)
    t0 = time.time()
    ref = torch.from_numpy(np.asarray(ref_wav, np.float32).reshape(1, -1)).to(dev)
    wav24 = _resampled(ref, ref_sr, S3GEN_SR)
    wav16 = _resampled(ref, ref_sr, S3_SR)
    t0 = lap(timings, "resample_s", t0, dev)
    # pad to a whole mel hop so mel frames == 2 * tokens
    hop = cfg.mel_hop
    if wav24.shape[1] % hop:
        wav24 = torch.nn.functional.pad(wav24, (0, hop - wav24.shape[1] % hop))
    mel24 = mel_ops.mel_spectrogram_24k(
        wav24, n_fft=cfg.mel_n_fft, num_mels=cfg.mel_num, hop_size=cfg.mel_hop,
        win_size=cfg.mel_win, fmin=cfg.mel_fmin, fmax=cfg.mel_fmax)
    mel24 = mel24.transpose(1, 2).cpu().numpy()           # (1, T_mel, 80)
    t0 = lap(timings, "mel_s", t0, dev)

    x_vector = xvector.inference(params["speaker_encoder"], wav16, cfg.campplus).cpu().numpy()
    t0 = lap(timings, "campplus_s", t0, dev)
    wav16p = s3tokenizer.pad_to_token_multiple(wav16.cpu().numpy())
    tokens, tok_lens = s3tokenizer.tokenize_wave(
        params["tokenizer"], torch.from_numpy(wav16p).to(dev), cfg=cfg.tokenizer)
    tokens, tok_lens = tokens.cpu().numpy(), tok_lens.cpu().numpy()
    lap(timings, "tokenizer_s", t0, dev)
    if mel24.shape[1] != 2 * tokens.shape[1]:
        n = mel24.shape[1] // 2
        tokens = tokens[:, :n]
        tok_lens = np.minimum(tok_lens, n)
    return dict(
        prompt_token=tokens.astype(np.int64),
        prompt_token_len=tok_lens.astype(np.int64),
        prompt_feat=mel24.astype(np.float32),
        prompt_feat_len=None,
        embedding=x_vector.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# VoiceProfile (.npy), byte-compatible with the JAX package's
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class VoiceProfile:
    """Dict-in-npy voice profile: the reference dict, plus the voice
    encoder's embedding for T3."""
    embedding: np.ndarray
    prompt_feat: Optional[np.ndarray] = None
    prompt_feat_len: Optional[int] = None
    prompt_token: Optional[np.ndarray] = None
    prompt_token_len: Optional[np.ndarray] = None
    ve_embedding: Optional[np.ndarray] = None

    def save(self, path: str):
        data = {"embedding": np.asarray(self.embedding)}
        if self.prompt_feat is not None:
            data["prompt_feat"] = np.asarray(self.prompt_feat)
        if self.prompt_feat_len is not None:
            data["prompt_feat_len"] = self.prompt_feat_len
        if self.prompt_token is not None:
            data["prompt_token"] = np.asarray(self.prompt_token)
        if self.prompt_token_len is not None:
            data["prompt_token_len"] = np.asarray(self.prompt_token_len)
        if self.ve_embedding is not None:
            data["ve_embedding"] = np.asarray(self.ve_embedding)
        np.save(path, data)

    @classmethod
    def load(cls, path: str) -> "VoiceProfile":
        data = np.load(path, allow_pickle=True).item()
        return cls(
            embedding=data["embedding"],
            prompt_feat=data.get("prompt_feat"),
            prompt_feat_len=data.get("prompt_feat_len"),
            prompt_token=data.get("prompt_token"),
            prompt_token_len=data.get("prompt_token_len"),
            ve_embedding=data.get("ve_embedding"),
        )


@torch.no_grad()
def save_voice_clone(params, ref_wav: np.ndarray, ref_sr: int, save_path: str,
                     cfg: S3GenConfig = S3GenConfig()):
    """192-d CAMPPlus embedding -> .npy."""
    wav = torch.from_numpy(np.asarray(ref_wav, np.float32).reshape(1, -1)).to(
        _param_device(params))
    emb = xvector.inference(params["speaker_encoder"], _resampled(wav, ref_sr, S3_SR),
                            cfg.campplus).cpu().numpy()
    np.save(save_path, emb)
    return emb


def save_voice_profile(params, ref_wav: np.ndarray, ref_sr: int, save_path: str,
                       cfg: S3GenConfig = S3GenConfig()):
    """Full profile -> .npy."""
    rd = embed_ref(params, ref_wav, ref_sr, cfg)
    VoiceProfile(
        embedding=rd["embedding"], prompt_feat=rd["prompt_feat"],
        prompt_feat_len=rd["prompt_feat_len"], prompt_token=rd["prompt_token"],
        prompt_token_len=rd["prompt_token_len"],
    ).save(save_path)


def drop_invalid_tokens(x: np.ndarray) -> np.ndarray:
    """Keep only real speech codes < 6561: the second step of cleaning T3's
    tokens, after s3tokenizer.drop_invalid_tokens (the SOS / EOS cut)."""
    x = np.asarray(x).reshape(-1)
    return x[x < SPEECH_VOCAB_SIZE]
