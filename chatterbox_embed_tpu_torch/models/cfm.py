"""Conditional flow matching: Euler ODE solver with classifier-free guidance,
the PyTorch counterpart of `chatterbox_embed_tpu/models/cfm.py` (the plain
solver: CFG on every step, no mid-stack reuse).

The Euler steps are a Python loop whose body is one estimator call on a CFG
batch of 2 (cond / uncond). The ODE state stays fp32; the estimator runs in
the compute dtype. The noise is the JAX package's fixed numpy Philox buffer,
made by the same numpy code, so both packages start from the same bits.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import CFMConfig, FlowDecoderConfig
from . import flow_decoder


@functools.lru_cache(maxsize=2)
def fixed_noise(n_feats: int = 80, frames: int = 50 * 300) -> np.ndarray:
    """Deterministic noise buffer (1, frames, n_feats), fp32 (the JAX
    package's cfm.fixed_noise, bit for bit)."""
    g = np.random.Generator(np.random.Philox(54321))
    return g.standard_normal(size=(1, frames, n_feats), dtype=np.float32)


def t_span_cosine(n_timesteps: int) -> np.ndarray:
    ts = np.linspace(0.0, 1.0, n_timesteps + 1, dtype=np.float32)
    return (1.0 - np.cos(ts * 0.5 * np.pi)).astype(np.float32)


def solve_euler(params, z, mu, spks, cond, mask=None,
                cfm: CFMConfig = CFMConfig(),
                dec_cfg: FlowDecoderConfig = FlowDecoderConfig(),
                dtype=torch.float32):
    """Integrate dx/dt = v(x, t) from noise to mel (channel-last).

      z:    (B, T, 80) initial noise
      mu:   (B, T, 80) encoder features
      spks: (B, 80) projected speaker embedding
      cond: (B, T, 80) prompt conditioning
    Returns (B, T, 80) fp32 mel. The uncond branch zeroes mu, spks and cond
    but keeps x and t.
    """
    b = z.shape[0]
    t_span = t_span_cosine(cfm.n_timesteps)
    dts = t_span[1:] - t_span[:-1]                 # fp32, as the JAX scan's xs
    w = cfm.inference_cfg_rate

    mu2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks2 = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    mask2 = None if mask is None else torch.cat([mask, mask], dim=0)

    x = z.float()
    for t, dt in zip(t_span[:-1], dts):
        x2 = torch.cat([x, x], dim=0)
        t2 = torch.full((2 * b,), float(t), dtype=torch.float32, device=x.device)
        v = flow_decoder.forward(params, x2, mu2, t2, spks2, cond2, mask2,
                                 dec_cfg, dtype)
        v_cond, v_uncond = v[:b], v[b:]
        v_cfg = (1.0 + w) * v_cond - w * v_uncond
        x = x + float(dt) * v_cfg
    return x


def generate_mel(params, mu, spks, cond, mask=None, cfm: CFMConfig = CFMConfig(),
                 dec_cfg: FlowDecoderConfig = FlowDecoderConfig(),
                 dtype=torch.float32):
    """mu (B, T, 80) -> mel (B, T, 80) from the fixed noise buffer."""
    b, tlen, nf = mu.shape
    z = torch.from_numpy(fixed_noise(nf)[:, :tlen, :]).to(mu.device)
    z = z.expand(b, tlen, nf)
    return solve_euler(params, z, mu, spks, cond, mask, cfm, dec_cfg, dtype)
