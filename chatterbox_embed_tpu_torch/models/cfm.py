"""Conditional flow matching: Euler ODE solver with classifier-free guidance,
the PyTorch counterpart of `chatterbox_embed_tpu/models/cfm.py`, with the
batched path's two options: the DeepCache stride (`cache_every`) and the
CFG interval (`cfg_steps`), and the streaming window's noise at absolute
frame positions (`generate_mel_stream`).

The Euler steps are a Python loop (the JAX package's lax.scan, and its
lax.cond over the reuse flags) whose body is one estimator call on a CFG
batch of 2 rows (cond / uncond) per utterance. The ODE state stays fp32;
the estimator runs in the compute dtype. The noise is the JAX package's fixed numpy Philox buffer,
made by the same numpy code, so both packages start from the same bits.

`compute_loss` is the flow-matching training loss; its time, noise and CFG
keep draws come from a draw source (`ops/sampling.py:Draws.flow_train`).
On a mesh each rank draws for the whole batch and takes its rows.

Under `comm` (parallel/sp.py) the solver runs on one shard of the T axis;
DeepCache is off there, as in the JAX package.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import CFMConfig, FlowDecoderConfig
from ..device import constant
from . import flow_decoder


@functools.lru_cache(maxsize=2)
def fixed_noise(n_feats: int = 80, frames: int = 50 * 300) -> np.ndarray:
    """Deterministic noise buffer (1, frames, n_feats), fp32 (the JAX
    package's cfm.fixed_noise, bit for bit)."""
    g = np.random.Generator(np.random.Philox(54321))
    return g.standard_normal(size=(1, frames, n_feats), dtype=np.float32)


def _noise(n_feats: int, device) -> torch.Tensor:
    """fixed_noise(n_feats) on `device`, copied there once."""
    return constant(("cfm_noise", n_feats), device, lambda: fixed_noise(n_feats))


def t_span_cosine(n_timesteps: int) -> np.ndarray:
    ts = np.linspace(0.0, 1.0, n_timesteps + 1, dtype=np.float32)
    return (1.0 - np.cos(ts * 0.5 * np.pi)).astype(np.float32)


def reuse_flags(n_steps: int, cache_every: int) -> list:
    """DeepCache schedule: step i reuses the cached mid stack unless it is
    a multiple of the stride or the last step."""
    return [i % cache_every != 0 and i != n_steps - 1 for i in range(n_steps)]


def solve_euler(params, z, mu, spks, cond, mask=None,
                cfm: CFMConfig = CFMConfig(),
                dec_cfg: FlowDecoderConfig = FlowDecoderConfig(),
                dtype=torch.float32, cache_every=None, cfg_steps=None, comm=None):
    """Integrate dx/dt = v(x, t) from noise to mel (channel-last).

      z:    (B, T, 80) initial noise
      mu:   (B, T, 80) encoder features
      spks: (B, 80) projected speaker embedding
      cond: (B, T, 80) prompt conditioning
      cache_every: DeepCache stride K. With K >= 2 (and more than 2 steps)
        the estimator's mid stack is recomputed only on steps that are a
        multiple of K and on the last step; the steps between reuse the
        cached mid output and run only the down and up stages. None or
        0/1: every step runs the whole estimator.
      cfg_steps: CFG interval k: the cond/uncond pair runs on the first k
        steps only, and the later steps integrate the cond-only velocity
        on B rows. None, <= 0 or >= the step count: CFG on every step.
      comm: parallel.sp.SeqComm when T is this rank's shard of an sp mesh
        (flow_decoder.forward); no DeepCache stride under it.
    Returns (B, T, 80) fp32 mel. The uncond branch zeroes mu, spks and cond
    but keeps x and t. With both options off this is the plain solver.
    """
    b = z.shape[0]
    t_span = t_span_cosine(cfm.n_timesteps)
    dts = t_span[1:] - t_span[:-1]                 # fp32, as the JAX scan's xs
    w = cfm.inference_cfg_rate
    n_steps = len(dts)
    k_cfg = n_steps if cfg_steps is None or int(cfg_steps) <= 0 else min(int(cfg_steps),
                                                                         n_steps)
    use_cache = (cache_every is not None and int(cache_every) >= 2 and n_steps > 2
                 and comm is None)
    flags = reuse_flags(n_steps, int(cache_every)) if use_cache else [False] * n_steps

    mu2 = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks2 = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    mask2 = None if mask is None else torch.cat([mask, mask], dim=0)

    x = z.float()
    mid = None
    for i, (t, dt) in enumerate(zip(t_span[:-1], dts)):
        pair = i < k_cfg
        if i == k_cfg and mid is not None:
            # the cond rows' cached mid output is the pair batch's first B
            # rows: a reuse step right after the interval sees its own rows
            mid = mid[:b]
        rows = 2 * b if pair else b
        xr = torch.cat([x, x], dim=0) if pair else x
        tr = torch.full((rows,), float(t), dtype=torch.float32, device=x.device)
        args = (xr, mu2, tr, spks2, cond2, mask2) if pair else (xr, mu, tr, spks, cond, mask)
        if use_cache:
            v, mid = flow_decoder.forward_mid_cached(params, *args, dec_cfg, dtype,
                                                     mid_feats=mid, reuse_mid=flags[i])
        else:
            v = flow_decoder.forward(params, *args, dec_cfg, dtype, comm=comm)
        if pair:
            v = (1.0 + w) * v[:b] - w * v[b:]
        x = x + float(dt) * v
    return x


def generate_mel(params, mu, spks, cond, mask=None, cfm: CFMConfig = CFMConfig(),
                 dec_cfg: FlowDecoderConfig = FlowDecoderConfig(),
                 dtype=torch.float32, cache_every=None, cfg_steps=None):
    """mu (B, T, 80) -> mel (B, T, 80) from the fixed noise buffer; the
    solver options are solve_euler's."""
    b, tlen, nf = mu.shape
    z = _noise(nf, mu.device)[:, :tlen, :].expand(b, tlen, nf)
    return solve_euler(params, z, mu, spks, cond, mask, cfm, dec_cfg, dtype,
                       cache_every=cache_every, cfg_steps=cfg_steps)


def generate_mel_stream(params, mu, spks, cond, mask, prompt_frames: int, noise_off: int,
                        cfm: CFMConfig = CFMConfig(),
                        dec_cfg: FlowDecoderConfig = FlowDecoderConfig(),
                        dtype=torch.float32):
    """The windowed streaming variant of generate_mel: the prompt frames
    take the fixed buffer's first `prompt_frames` rows and the generated
    frames the rows at ABSOLUTE positions prompt_frames + noise_off + j, so
    overlapping regions of successive windows integrate the same noise.
    The start is clamped into the buffer, as JAX's dynamic_slice clamps it.
    The plain solver (no DeepCache stride, CFG on every step)."""
    b, tlen, nf = mu.shape
    buf = _noise(nf, mu.device)
    n_gen = tlen - prompt_frames
    start = min(max(prompt_frames + int(noise_off), 0), buf.shape[1] - n_gen)
    z = torch.cat([buf[:, :prompt_frames], buf[:, start:start + n_gen]], dim=1)
    z = z.expand(b, tlen, nf)
    return solve_euler(params, z, mu, spks, cond, mask, cfm, dec_cfg, dtype)


def compute_loss(params, draws, x1, mu, spks, cond, mask,
                 cfm: CFMConfig = CFMConfig(),
                 dec_cfg: FlowDecoderConfig = FlowDecoderConfig(),
                 dtype=torch.float32, mesh=None):
    """Flow-matching training loss (the JAX package's cfm.compute_loss).

    x1: (B, T, 80) target mel; mu, cond: (B, T, 80); spks: (B, 80); mask:
    (B, T, 1). `draws.flow_train(B, x1.shape)` gives the time, the noise and
    the CFG keep draw. Returns the masked mean squared error of the
    estimator's velocity, a scalar fp32 tensor.

    mesh: the arguments are the whole batch; each rank draws for all of it
    from the one source (so the draws are one process's), takes its rows
    over dp (`Mesh.rows`) and divides their squared error by the whole
    batch's sum(mask) * 80, which every rank holds: the dp sum of the
    ranks' losses is one process's."""
    b = x1.shape[0]
    t, z, keep_u = (a.to(x1.device) for a in draws.flow_train(b, tuple(x1.shape)))
    den = torch.sum(mask) * x1.shape[-1]
    if mesh is not None:
        r0, r1 = mesh.rows(b)
        t, z, keep_u, x1, mu, spks, cond, mask = (
            a[r0:r1] for a in (t, z, keep_u, x1, mu, spks, cond, mask))
    if cfm.t_scheduler == "cosine":
        t = 1.0 - torch.cos(t * 0.5 * math.pi)
    t_b = t[:, None, None]
    y = (1.0 - (1.0 - cfm.sigma_min) * t_b) * z + t_b * x1
    u = x1 - (1.0 - cfm.sigma_min) * z

    if cfm.training_cfg_rate > 0:
        keepf = (keep_u > cfm.training_cfg_rate).float()
        mu = mu * keepf[:, None, None]
        spks = spks * keepf[:, None]
        cond = cond * keepf[:, None, None]

    pred = flow_decoder.forward(params, y, mu, t, spks, cond, mask, dec_cfg, dtype)
    num = torch.sum(torch.square((pred - u) * mask))
    return num / torch.clamp(den, min=1.0)
