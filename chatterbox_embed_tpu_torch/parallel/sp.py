"""Sequence parallelism (sp) for mel generation: the PyTorch counterpart of
`chatterbox_embed_tpu/parallel/sp.py`.

One long utterance splits its T frames over the ranks of an sp mesh, each
a process (parallel/mesh.py), and every rank runs the CFM solver on its
shard (`cfm.solve_euler(..., comm=SeqComm(mesh))`):
- every pointwise op (linears, norms, the ODE's arithmetic) runs on T/n
  frames with no communication;
- each causal k=3 conv prepends a 2-frame halo from the left neighbour
  (`SeqComm.halo`, zeros on the first shard, which is the causal pad), so
  the sharded conv equals the unsharded one;
- attention keeps the queries sharded and gathers K/V over sp
  (`SeqComm.gather`), plain `layers.mha` as the JAX package runs it there;
  the key mask is gathered once a call.
Everything runs outside autograd (mel generation only).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CFMConfig, FlowDecoderConfig
from ..models import cfm
from .mesh import Mesh, visible_devices


def make_sp_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A line of n ranks named sp (`mesh.visible_devices`: the first n
    cards, or n ranks on `device`)."""
    return Mesh(np.asarray(visible_devices(n_devices, device), dtype=object), ("sp",))


class SeqComm:
    """The collectives flow_decoder.forward makes when its T axis is this
    rank's shard of `mesh`'s `axis` (the JAX package's SeqComm names the
    axis only; a process also needs the mesh's group). Called on every rank
    of the axis, in the same order."""

    def __init__(self, mesh: Mesh, axis: str = "sp"):
        self.mesh, self.axis = mesh, axis

    def halo(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """x (B, T_local, C) with the left neighbour's last `width` frames
        prepended (zeros on the first shard: the causal pad)."""
        return torch.cat([self.mesh.shift(x[:, -width:], self.axis), x], dim=1)

    def gather(self, x: torch.Tensor, axis: int = 1) -> torch.Tensor:
        """Every shard's x concatenated along `axis`: the whole T."""
        return self.mesh.gather(x, self.axis, axis)


def _check(mesh: Mesh, tlen: int) -> None:
    if mesh.axis_names != ("sp",):
        raise ValueError(f"sp_generate_mel runs on an sp mesh (make_sp_mesh), not on axes "
                         f"{mesh.axis_names}")
    if -(-tlen // mesh.sp) < 2:
        raise ValueError(f"{tlen} frames over {mesh.sp} sp ranks: a shard needs at least the "
                         f"2 frames of a causal conv's halo")


def sp_generate_mel(mesh: Mesh, params, mu, spks, cond, mask=None, temperature: float = 1.0,
                    cfm_cfg: CFMConfig = CFMConfig(),
                    dec_cfg: FlowDecoderConfig = FlowDecoderConfig(),
                    dtype=torch.float32) -> torch.Tensor:
    """mu (B, T, 80) -> mel (B, T, 80) with T split over the sp mesh.

    cfm.generate_mel's result with another layout: the same fixed noise
    buffer, the same Euler and CFG arithmetic. T is zero-padded to a
    multiple of the shard count (the pad frames are masked out of attention
    and the convs, and cut from the result). Called on the leader, it runs
    on every rank of the mesh and returns the whole mel there. `params` is
    the estimator's tree (sent by value) or a replicated tree kept on the
    mesh (`parallel.replicate`)."""
    _check(mesh, mu.shape[1])
    if mesh.leads():
        return mesh.call(sp_generate_mel, mesh, params, mu, spks, cond, mask, temperature,
                         cfm_cfg, dec_cfg, dtype)
    dev = mesh.device
    mu, spks, cond = (torch.as_tensor(a, device=dev).float() for a in (mu, spks, cond))
    n = mesh.sp
    b, t, nf = mu.shape
    pad = (-t) % n
    mask = (torch.ones((b, t, 1), device=dev) if mask is None
            else torch.as_tensor(mask, device=dev).float())
    mu, cond, mask = (F.pad(a, (0, 0, 0, pad)) for a in (mu, cond, mask))
    per = (t + pad) // n
    z = torch.from_numpy(cfm.fixed_noise(nf)[:, :t + pad]).to(dev) * temperature
    z = z.expand(b, t + pad, nf)
    s0 = mesh.sp_index * per
    with torch.no_grad():
        out = cfm.solve_euler(params, z[:, s0:s0 + per], mu[:, s0:s0 + per], spks,
                              cond[:, s0:s0 + per], mask[:, s0:s0 + per], cfm_cfg, dec_cfg,
                              dtype, comm=SeqComm(mesh))
        return mesh.gather(out, "sp", 1)[:, :t]
