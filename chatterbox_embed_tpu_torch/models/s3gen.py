"""S3Gen: speech tokens -> mel (conformer + CFM) -> waveform (HiFT), the
PyTorch counterpart of `chatterbox_embed_tpu/models/s3gen.py` for one voice
(the shared-prompt layout; conditioning from reference audio is not part of
this port yet).
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
                dtype=torch.float32):
    """CausalMaskedDiffWithXvec inference for one shared voice prompt.

      tokens:        (B, T_tok) target speech tokens
      token_len:     (B,) valid lengths of [prompt; target]
      prompt_tokens: (B, T_p) reference speech tokens
      prompt_feat:   (B, T_mel_p, 80) reference mel (2 frames per token)
      embedding:     (B, 192) x-vector
    Returns (B, 2*T_tok, 80) fp32 mel of the generated part.
    """
    fl = params["flow"]
    emb = embedding / torch.linalg.norm(embedding, dim=-1, keepdim=True)
    spks = L.linear(fl["spk_embed_affine"], emb.float())

    full = torch.cat([prompt_tokens, tokens], dim=1).long()
    t = full.shape[1]
    mask = torch.arange(t, device=full.device)[None] < token_len[:, None]
    x = L.embedding(fl["input_embedding"], full.clamp_min(0))
    x = x * mask[..., None].to(x.dtype)

    h = conformer.forward(fl["encoder"], x, token_len, cfg.flow.encoder, dtype)
    mel_len1 = prompt_feat.shape[1]
    h = L.linear(fl["encoder_proj"], h.float())

    conds = torch.zeros((h.shape[0], h.shape[1], cfg.flow.output_size),
                        dtype=h.dtype, device=h.device)
    conds[:, :mel_len1] = prompt_feat.to(h.dtype)

    # mel-rate validity mask: bucket padding must not leak into valid frames
    mel_valid = cfg.flow.token_mel_ratio * token_len
    mel_mask = (torch.arange(h.shape[1], device=h.device)[None, :]
                < mel_valid[:, None])[..., None].to(h.dtype)

    mel = cfm.generate_mel(fl["decoder"], h, spks, conds, mask=mel_mask,
                           cfm=cfg.flow.cfm, dec_cfg=cfg.flow.decoder, dtype=dtype)
    return mel[:, mel_len1:]


def trim_fade(sr: int = S3GEN_SR) -> np.ndarray:
    """20 ms silence + 20 ms cosine fade-in."""
    n = sr // 50
    fade = np.zeros(2 * n, np.float32)
    fade[n:] = (np.cos(np.linspace(np.pi, 0.0, n)) + 1.0) / 2.0
    return fade


@torch.no_grad()
def token_to_wav(params, tokens, token_len, prompt_tokens, prompt_feat,
                 embedding, draws, cfg: S3GenConfig = S3GenConfig(),
                 dtype=torch.float32):
    """tokens -> (B, T_wav) fp32 wav with the trim fade applied; `draws`
    feeds the HiFT source."""
    mel = flow_to_mel(params, tokens, token_len, prompt_tokens, prompt_feat,
                      embedding, cfg, dtype)
    wav, _src = hifigan.inference(params["hift"], mel, draws, cfg.hift, dtype)
    fade = torch.from_numpy(trim_fade()).to(wav.device)
    wav[:, : fade.shape[0]] *= fade
    return wav


def drop_invalid_tokens(x: np.ndarray) -> np.ndarray:
    """Keep only real speech codes < 6561."""
    x = np.asarray(x).reshape(-1)
    return x[x < SPEECH_VOCAB_SIZE]
