"""S3Gen: speech tokens -> mel (conformer + CFM) -> waveform (HiFT), the
PyTorch counterpart of `chatterbox_embed_tpu/models/s3gen.py`: one shared
voice prompt, or ragged per-row prompts for multi-voice batches, and the
windowed flow of streaming (`flow_to_mel_window`)
(conditioning from reference audio is not part of this port yet).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import S3GEN_SR, SPEECH_VOCAB_SIZE, S3GenConfig
from . import layers as L
from . import cfm, conformer, flow_decoder, hifigan


def init(init: L.Init, cfg: S3GenConfig = S3GenConfig()):
    """The flow and vocoder parameters (the speaker encoder and the speech
    tokenizer belong to the conditioning path, which is not ported yet)."""
    flow = {
        "input_embedding": L.embedding_init(init, cfg.flow.vocab_size, cfg.flow.input_size,
                                            std=0.02),
        "spk_embed_affine": L.linear_init(init, cfg.flow.spk_embed_dim, cfg.flow.output_size),
        "encoder": conformer.init(init, cfg.flow.encoder),
        "encoder_proj": L.linear_init(init, cfg.flow.encoder.output_size, cfg.flow.output_size),
        "decoder": flow_decoder.init(init, cfg.flow.decoder),
    }
    return {"flow": flow, "hift": hifigan.init(init, cfg.hift)}


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

    h = conformer.forward(fl["encoder"], x, token_len, cfg.flow.encoder, dtype)
    mel_len1 = prompt_feat.shape[1]
    h = L.linear(fl["encoder_proj"], h.float())

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
    # the start clamped into mu, as JAX's dynamic_slice clamps it
    tail = mel_len1 + r * int(vlen.reshape(-1)[0]) - pin_max - r * look
    tail = min(max(tail, 0), mu.shape[1] - pin_max)
    return mel[:, mel_len1:], mu[:, tail:tail + pin_max]


def trim_fade(sr: int = S3GEN_SR) -> np.ndarray:
    """20 ms silence + 20 ms cosine fade-in."""
    n = sr // 50
    fade = np.zeros(2 * n, np.float32)
    fade[n:] = (np.cos(np.linspace(np.pi, 0.0, n)) + 1.0) / 2.0
    return fade


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
    wav, _src = hifigan.inference(params["hift"], mel, draws, cfg.hift, dtype)
    fade = torch.from_numpy(trim_fade()).to(wav.device)
    wav[:, : fade.shape[0]] *= fade
    return wav


def drop_invalid_tokens(x: np.ndarray) -> np.ndarray:
    """Keep only real speech codes < 6561."""
    x = np.asarray(x).reshape(-1)
    return x[x < SPEECH_VOCAB_SIZE]
