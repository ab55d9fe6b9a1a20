"""What the two masked-attention kernels (K2 `rel_attention`, K3
`flash_attention`) share on the Python side: the width check of their CUDA
wrappers, the tile plan of their bf16 tensor-core kernel
(`csrc/masked_attention_tc.cuh`) and a plain PyTorch walk of that kernel's
algorithm.

`plan` states what the launcher will do for a call: query rows a block, ring
depth, stage and shared-memory bytes, grid. The numbers
below mirror the header's constants; a test parses the header and holds the
two equal.

`tiled_reference` walks the key tiles as the kernel does. Tests hold it
against the two plain versions, and the smoke run uses it to tell a fault of
the algorithm from a fault of the kernel's layouts. Nothing on a serving
path calls it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

TILE = 64                   # query rows a block, keys a tile, slice width, value width
STAGE_BYTES = 8192          # one ring stage: a 64 x 64 bf16 tile
MAX_DA = 576                # widest q.k the resident Q leaves room for
SMEM_LIMIT = 232448         # dynamic shared memory a block may have on an H100
STAGES_NARROW = 6           # ring depth at a q.k width of 64
STAGES_WIDE = 5             # ring depth at 128..576
LOG2E = 1.4426950408889634


def check_width(da: int, dtype) -> None:
    """Raises on a q.k width or dtype no kernel takes: fp32 (the SIMT
    kernel) any positive multiple of 64, bf16 (the tensor-core kernel) up to
    576."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"masked attention: dtype {dtype} not supported (float32, bfloat16)")
    if da < TILE or da % TILE:
        raise ValueError(f"masked attention: q.k width {da} is not a positive multiple of {TILE}")
    if dtype == torch.bfloat16 and da > MAX_DA:
        raise ValueError(f"masked attention: bf16 q.k width {da} > {MAX_DA}")


class Plan(NamedTuple):
    rows: int               # query rows a block
    stages: int             # ring depth (the fp32 kernel has no ring: 0)
    stage_bytes: int
    smem_bytes: int         # dynamic shared memory a block
    query_tiles: int        # the grid is (query_tiles, batch * heads)


SIMT_SMEM_BYTES = 4 * (64 * 65 + 64 * 65 + 64 * 64 + 64 * 65) + 4 * 64


def plan(t: int, da: int, dtype) -> Plan:
    """What the launcher does for a call with `t` keys and a q.k width of
    `da`: bf16 the tensor-core kernel (the resident Q, then the ring), fp32
    the SIMT kernel. Raises on what no kernel takes."""
    if t < 1:
        raise ValueError("masked attention: empty sequence")
    check_width(da, dtype)
    tiles = -(-t // TILE)
    if dtype == torch.float32:
        return Plan(TILE, 0, 0, SIMT_SMEM_BYTES, tiles)
    stages = STAGES_NARROW if da == TILE else STAGES_WIDE
    return Plan(TILE, stages, STAGE_BYTES, (da // TILE + stages) * STAGE_BYTES, tiles)


def tiled_reference(q, k, v, key_valid, scale: float, block_k: int = TILE):
    """softmax((q . k^T) * scale) . v over each row's valid keys, walked in
    key tiles of `block_k` as the tensor-core kernel walks them: a tile with
    no valid key is skipped; scores in fp32 and in the exp2 domain (scale *
    log2(e) folded in); invalid keys, and keys past T in the last tile, at
    -inf; a running max m and sum l per query row, the sum taken from the
    unrounded fp32 p; p rounded to v's dtype only for p . v, which
    accumulates in fp32; a row without a live key gives 0. q, k (B, T, H,
    Da); v (B, T, H, Dv); key_valid (B, T) bool. Returns (B, T, H, Dv) in
    v's dtype."""
    b, t, h, _ = q.shape
    dv = v.shape[-1]
    qf = q.float().permute(0, 2, 1, 3)                      # (B, H, T, Da)
    kf = k.float().permute(0, 2, 1, 3)
    vf = v.float().permute(0, 2, 1, 3)
    m = torch.full((b, h, t), -math.inf, device=q.device)
    l = torch.zeros((b, h, t), device=q.device)
    o = torch.zeros((b, h, t, dv), device=q.device)
    for k0 in range(0, t, block_k):
        valid = key_valid[:, k0:k0 + block_k]               # (B, <= block_k): past T cut off
        live = valid.any(dim=1)                             # (B,) rows whose tile is live
        if not bool(live.any()):
            continue
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + block_k]) * (scale * LOG2E)
        s = s.masked_fill(~valid[:, None, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        sub = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        f = torch.exp2(m - sub)
        p = torch.exp2(s - sub[..., None])
        l_new = l * f + p.sum(dim=-1)
        o_new = o * f[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vf[:, :, k0:k0 + block_k])
        # a row whose tile is dead does not touch its state (the kernel skips it)
        keep = live[:, None, None]
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l_new, l)
        o = torch.where(keep[..., None], o_new, o)
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return (o * inv[..., None]).permute(0, 2, 1, 3).to(v.dtype)
