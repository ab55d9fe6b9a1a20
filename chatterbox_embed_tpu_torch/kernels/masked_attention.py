"""What the two masked-attention kernels (K2 `rel_attention`, K3
`flash_attention`) share on the Python side: the width check of their CUDA
wrappers, the tile plan of their bf16 tensor-core kernel
(`csrc/masked_attention_tc.cuh`) and a plain PyTorch walk of that kernel's
algorithm; and the same two for K3's backward K3b (`plan_bwd`,
`tiled_reference_bwd`; `csrc/flash_attention_bwd.cu`), with the rounding of
P and dS that the walk and K3b's plain version share (`round_operand`).

`plan` states what the launcher will do for a call: query rows a block, ring
depth, stage and shared-memory bytes, grid. The numbers
below mirror the header's constants; a test parses the header and holds the
two equal.

`plan_bwd` mirrors K3b's constants the same way (a test parses
`csrc/flash_attention_bwd.cu`). `tiled_reference` walks the key tiles as
the kernel does, `tiled_reference_bwd` the tiles of K3b-dq and K3b-dkv.
Tests hold each against its plain versions, and the smoke run uses
`tiled_reference` to tell a fault of the algorithm from a fault of the
kernel's layouts. Nothing on a serving path calls either.
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
# K3b (csrc/flash_attention_bwd.cu)
BWD_THREADS = 128           # one warpgroup (bf16); 16 x 8 threads of 4 x 8 (fp32)
BWD_SLOTS = 4               # bf16 ring depth: streamed pairs of 64 x 64 tiles
BWD_AHEAD = 2               # pairs in flight ahead of the products
BWD_SLOT_BYTES = 2 * STAGE_BYTES
BWD_STAT_BYTES = 512        # lse and di of a query tile (K3b-dkv's ring)
BWD_BLOCKS = 2              # blocks an SM of every K3b kernel (launch bounds)
BWD_PITCH = 68              # fp32 tile row pitch, floats


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


class BwdPlan(NamedTuple):
    threads: int            # a block
    slots: int              # bf16 ring depth (fp32 stages each tile in place: 0)
    ahead: int              # ring slots in flight ahead of the products
    smem_dq: int            # dynamic shared memory of a K3b-dq block
    smem_dkv: int           # ... of a K3b-dkv block
    blocks: int             # blocks an SM (launch bounds)
    tiles: int              # each grid is (tiles, batch * heads)


def plan_bwd(t: int, dtype) -> BwdPlan:
    """What K3b's launchers do for `t` rows (head width 64): bf16 keeps a
    resident pair of tiles and a ring of BWD_SLOTS streamed pairs (K3b-dkv's
    with each query tile's lse and di), fp32 stages five (dq) or six (dkv)
    fp32 tiles of pitch BWD_PITCH (dkv with lse and di)."""
    if t < 1:
        raise ValueError("flash_attention_backward: empty sequence")
    check_width(TILE, dtype)
    tiles = -(-t // TILE)
    if dtype == torch.float32:
        tile = 4 * TILE * BWD_PITCH
        return BwdPlan(BWD_THREADS, 0, 0, 5 * tile, 6 * tile + 2 * 4 * TILE, BWD_BLOCKS, tiles)
    ring = 2 * STAGE_BYTES + BWD_SLOTS * BWD_SLOT_BYTES
    return BwdPlan(BWD_THREADS, BWD_SLOTS, BWD_AHEAD, ring, ring + BWD_SLOTS * BWD_STAT_BYTES,
                   BWD_BLOCKS, tiles)


def round_operand(x, dtype):
    """An fp32 P or dS rounded to the inputs' dtype as the operand of a
    product, as the stock TPU op rounds them (`p.T.astype(do.dtype)` :900,
    `ds.T.astype(do.dtype)` :918, `ds.astype(k.dtype)` :1258 of
    flash_attention.py, jax 0.9.0); fp32 inputs keep it as it is."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def tiled_reference_bwd(q, k, v, key_valid, out, dout, lse, block: int = TILE):
    """K3b's tile walk in plain PyTorch: (dq, dk, dv, di) of K3 from its lse
    (B, H, T). K3b-dq walks the key tiles with a valid key in its row, K3b-dkv
    gives a key tile without one zeros and otherwise walks every query tile;
    P = exp2(s * scale * log2(e) - lse * log2(e)) at the valid keys (0 where
    lse is +inf), sums in fp32, and with bf16 inputs P and dS rounded to
    bf16 as the operands of dQ += dS K, dV += P^T dO and dK += dS^T Q (the
    tensor-core kernels' A fragments). q, k, v, out, dout (B, T, H, 64);
    key_valid (B, T) bool. Returns dq, dk, dv in q's dtype and di (B, H, T)
    fp32."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, of, gf = (x.float().permute(0, 2, 1, 3) for x in (q, k, v, out, dout))
    lse2 = (lse * LOG2E)[..., None]                         # (B, H, T, 1)
    di = (gf * of).sum(dim=-1)
    dq = torch.zeros((b, h, t, d), device=q.device)
    dk = torch.zeros_like(dq)
    dv = torch.zeros_like(dq)
    for k0 in range(0, t, block):
        ks = slice(k0, k0 + block)
        valid = key_valid[:, ks]                            # keys past T cut off
        live = valid.any(dim=1)[:, None, None, None]        # (B, 1, 1, 1): the tile's rows
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, ks])
        p = torch.where(valid[:, None, None, :], torch.exp2(s * (scale * LOG2E) - lse2),
                        torch.zeros_like(s))
        ds = p * (torch.einsum("bhqd,bhkd->bhqk", gf, vf[:, :, ks]) - di[..., None])
        # K3b-dq: this key tile's share of every query row (a dead tile is skipped)
        dq += torch.where(live, torch.einsum("bhqk,bhkd->bhqd", round_operand(ds, q.dtype),
                                             kf[:, :, ks]), 0.0)
        # K3b-dkv: the block of this key tile, over every query tile
        for q0 in range(0, t, block):
            qs = slice(q0, q0 + block)
            dv[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd", round_operand(p[:, :, qs], q.dtype),
                                         gf[:, :, qs])
            dk[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd", round_operand(ds[:, :, qs], q.dtype),
                                         qf[:, :, qs])
        dk[:, :, ks] = torch.where(live, dk[:, :, ks], 0.0)
        dv[:, :, ks] = torch.where(live, dv[:, :, ks], 0.0)
    back = (lambda x: x.permute(0, 2, 1, 3).to(q.dtype))
    return back(dq * scale), back(dk * scale), back(dv), di


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
