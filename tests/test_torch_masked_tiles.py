"""The algorithm of the port's bf16 tensor-core attention kernel
(csrc/masked_attention_tc.cuh, behind K2 rel_attention and K3
flash_attention), walked in plain PyTorch on the CPU
(kernels/masked_attention.py:tiled_reference), against the two plain
versions and the JAX package's Pallas kernel in interpret mode; and the
kernel's tile plan (`plan`) against the constants of the CUDA header. The
CUDA kernel itself is checked on the card by chip_smoke.py.

Tolerances. fp32: the walk and the plain versions differ in summation order
and in exp2(x * log2 e) against exp(x): 1e-5 on outputs of unit scale. bf16:
both round p to bf16 for p.v and the result to bf16 once, so they may differ
by one bf16 step of the output (2^-7 relative): 2e-2 of max(1, |ref|), the
limit the smoke run holds the kernel to (chip_smoke.py:ATT_TOL)."""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from chatterbox_embed_tpu.kernels import rel_attention as jrel
from chatterbox_embed_tpu_torch.kernels import _build
from chatterbox_embed_tpu_torch.kernels import flash_attention as tflash
from chatterbox_embed_tpu_torch.kernels import masked_attention as ma
from chatterbox_embed_tpu_torch.kernels import rel_attention as trel
from torch_parity import t

torch.set_num_threads(2)
ATT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
B, H, DV = 4, 2, 64
HEADER = _build.CSRC / "masked_attention_tc.cuh"
MASKS = ("prefix", "dead_first", "dead_middle", "dead_last", "one_per_tile", "empty_row")


def _mask(kind, tlen, rng):
    """(B, tlen) key masks in the kernel's 64-key tiles. Row 0 is always all
    valid; every row keeps a valid key except row 2 of `empty_row`."""
    pos = np.arange(tlen)
    tile = pos // 64
    n = tile[-1] + 1
    valid = np.zeros((B, tlen), bool)
    if kind == "prefix":
        valid = pos[None] < np.array([tlen, 1, max(1, tlen // 2), max(1, tlen - 3)])[:, None]
    elif kind == "dead_first":              # the first live tile comes late
        for r in range(B):
            valid[r] = tile >= min(r, n - 1)
    elif kind == "dead_middle":
        for r in range(B):
            valid[r] = (tile < 1) | (tile >= n - 1) | (rng.random(tlen) < 0.3 * (r % 2))
    elif kind == "dead_last":
        for r in range(B):
            valid[r] = tile <= max(0, n - 1 - r)
    elif kind == "one_per_tile":
        for r in range(B):
            valid[r] = pos % 64 == (7 * tile + 3 + r) % 64
            valid[r, tlen - 1] |= not valid[r].any()
    elif kind == "empty_row":
        valid = rng.random((B, tlen)) < 0.5
        valid[:, tlen - 1] = True
        valid[2] = False
    valid[0] = True
    return valid


def _inputs(rng, tlen, da, dtype):
    q = rng.standard_normal((B, tlen, H, da)).astype(np.float32) / np.sqrt(np.sqrt(da))
    k = rng.standard_normal((B, tlen, H, da)).astype(np.float32) / np.sqrt(np.sqrt(da))
    v = rng.standard_normal((B, tlen, H, DV)).astype(np.float32)
    return (t(x).to(dtype) for x in (q, k, v))


def _worst(out, ref, relative):
    diff = (out.float() - ref.float()).abs()
    if relative:
        diff = diff / ref.float().abs().clamp_min(1.0)
    return diff.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("da", [64, 576])
@pytest.mark.parametrize("tlen", [1, 40, 64, 65, 406])
def test_tile_walk_matches_plain_versions(rng, tlen, da, kind, dtype):
    q, k, v = _inputs(rng, tlen, da, dtype)
    valid = t(_mask(kind, tlen, rng))
    scale = 1.0 / np.sqrt(64)
    out = ma.tiled_reference(q, k, v, valid, scale)
    assert out.shape == (B, tlen, H, DV) and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    ref = trel.rel_attention_reference(q, k, v, valid, scale)
    assert _worst(out, ref, dtype == torch.bfloat16) <= ATT_TOL[dtype]
    empty = ~valid.any(dim=1)
    if empty.any():
        assert out[empty].float().abs().max().item() == 0.0
    if da == 64:
        # K3's plain version averages all keys in a row without a valid key
        # (the kernels give 0); no such row is on its path
        ref3 = tflash.flash_attention_reference(q, k, v, valid)
        assert _worst(out[~empty], ref3[~empty], dtype == torch.bfloat16) <= ATT_TOL[dtype]


@pytest.mark.parametrize("block_k", [16, 32, 128])
def test_tile_walk_does_not_depend_on_the_tile(rng, block_k):
    q, k, v = _inputs(rng, 150, 128, torch.float32)
    valid = t(_mask("dead_middle", 150, rng))
    a = ma.tiled_reference(q, k, v, valid, 0.125)
    b = ma.tiled_reference(q, k, v, valid, 0.125, block_k=block_k)
    assert _worst(a, b, False) <= ATT_TOL[torch.float32]


def test_tile_walk_matches_jax_kernel(rng):
    q, k, v = _inputs(rng, 130, 576, torch.float32)
    valid = _mask("dead_first", 130, rng)
    out = ma.tiled_reference(q, k, v, t(valid), 0.125)
    ref = jrel.rel_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(valid),
                             0.125, interpret=True)
    # the limits of tests/test_torch_rel_attention.py for this kernel
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-3)


@settings(max_examples=40, deadline=None)
@given(tlen=st.integers(1, 200), seed=st.integers(0, 2 ** 16),
       dead=st.lists(st.booleans(), min_size=4, max_size=4),
       density=st.floats(0.02, 1.0))
def test_tile_walk_on_arbitrary_masks(tlen, seed, dead, density):
    rng = np.random.default_rng(seed)
    q, k, v = _inputs(rng, tlen, 64, torch.float32)
    valid = rng.random((B, tlen)) < density
    for i, d in enumerate(dead):                # whole tiles off, any of the first four
        if d:
            valid[:, 64 * i:64 * (i + 1)] = False
    valid = t(valid)
    out = ma.tiled_reference(q, k, v, valid, 0.125)
    ref = trel.rel_attention_reference(q, k, v, valid, 0.125)
    assert _worst(out, ref, False) <= ATT_TOL[torch.float32]
    empty = ~valid.any(dim=1)
    assert out[empty].abs().sum().item() == 0.0


def _header_constants():
    text = HEADER.read_text()
    found = dict(re.findall(r"constexpr int (kTc\w+) = (\d+);", text))
    return {name: int(val) for name, val in found.items()}


def test_plan_constants_equal_the_header():
    c = _header_constants()
    assert c["kTcTile"] == ma.TILE and c["kTcStageBytes"] == ma.STAGE_BYTES
    assert c["kTcMaxDa"] == ma.MAX_DA and c["kTcSmemLimit"] == ma.SMEM_LIMIT == 232448
    assert c["kTcStageBytes"] == c["kTcTile"] * c["kTcTile"] * 2
    assert c["kTcStagesNarrow"] == ma.STAGES_NARROW and c["kTcStagesWide"] == ma.STAGES_WIDE
    assert c["kTcThreads"] == 2 * ma.TILE           # one warpgroup for 64 query rows
    # the header computes a block's bytes as (slices + kStages) * kTcStageBytes
    assert "(da / kTcTile + kStages) * kTcStageBytes" in HEADER.read_text()


@pytest.mark.parametrize("tlen", [40, 812, 2348])
@pytest.mark.parametrize("da", range(64, 577, 64))
def test_plan_fits_the_shared_memory(da, tlen):
    p = ma.plan(tlen, da, torch.bfloat16)
    c = _header_constants()
    assert p.rows == 64 and p.stage_bytes == c["kTcStageBytes"] and p.stages >= 3
    assert p.stages == c["kTcStagesNarrow" if da == 64 else "kTcStagesWide"]
    assert p.smem_bytes == (da // 64 + p.stages) * c["kTcStageBytes"] <= 232448
    # the blocks an SM the launch bounds ask for fit beside each other (each
    # block also reserves 1 KB of the SM's 228 KB)
    blocks = c["kTcBlocksNarrow" if da == 64 else "kTcBlocksWide"]
    assert blocks * (p.smem_bytes + 1024) <= 228 * 1024
    assert p.query_tiles == -(-tlen // 64)


def test_plan_of_the_fp32_kernel_and_what_it_refuses():
    p = ma.plan(812, 1024, torch.float32)
    assert p.rows == 64 and p.stages == 0 and p.smem_bytes == 66560 and p.query_tiles == 13
    for bad in (640, 1024):
        with pytest.raises(ValueError, match="576"):
            ma.plan(812, bad, torch.bfloat16)
    for bad in (0, 32, 100, 577):
        with pytest.raises(ValueError, match="multiple of 64"):
            ma.plan(812, bad, torch.bfloat16)
    with pytest.raises(ValueError, match="empty"):
        ma.plan(0, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="not supported"):
        ma.plan(8, 64, torch.float16)


class _OnCard:
    """Stands for a CUDA tensor where there is no card: the shape, dtype and
    layout of a meta tensor under the device name of the card."""

    def __init__(self, shape, dtype):
        self._m = torch.empty(shape, dtype=dtype, device="meta")
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = dtype, self._m.shape
        self.requires_grad = False

    def dim(self):
        return self._m.dim()

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 1 << 20


@pytest.mark.parametrize("da,match", [(640, "576"), (1152, "576"), (96, "multiple of 64"),
                                      (32, "multiple of 64")])
def test_cuda_call_the_kernel_cannot_take_raises_before_any_launch(monkeypatch, da, match):
    def no_build(*a, **k):
        raise AssertionError("the call reached the build of the kernel")
    monkeypatch.setattr(_build, "load", no_build)
    q = _OnCard((4, 70, 8, da), torch.bfloat16)
    v = _OnCard((4, 70, 8, 64), torch.bfloat16)
    valid = _OnCard((4, 70), torch.bool)
    before = trel.rel_attention.launches
    with pytest.raises(ValueError, match=match):
        trel.rel_attention(q, q, v, valid, 0.125)
    assert trel.rel_attention.launches == before
    # a width the bf16 kernel takes gets past the checks, to the build
    ok = _OnCard((4, 70, 8, 576), torch.bfloat16)
    with pytest.raises(AssertionError, match="reached the build"):
        trel.rel_attention(ok, ok, v, valid, 0.125)
    with pytest.raises(ValueError, match="scale > 0"):
        trel.rel_attention(ok, ok, v, valid, -0.125)


def test_flash_attention_checks_on_the_card(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the call reached the build of the kernel")
    monkeypatch.setattr(_build, "load", no_build)
    valid = _OnCard((4, 70), torch.bool)
    bad = _OnCard((4, 70, 8, 128), torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_attention(bad, bad, bad, valid)
    ok = _OnCard((4, 70, 8, 64), torch.bfloat16)
    with pytest.raises(AssertionError, match="reached the build"):
        tflash.flash_attention(ok, ok, ok, valid)
    assert tflash.flash_attention.launches == 0
