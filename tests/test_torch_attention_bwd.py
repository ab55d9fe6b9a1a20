"""K3's lse and K3b (K3's backward, csrc/flash_attention_bwd.cu) on the CPU:
the plain lse against the log-sum-exp of the JAX package's masked scores,
the lse-taking plain backward against `jax.vjp` of the JAX package's
`layers.mha`, the plain backward and the tile walk against the stock Pallas
TPU op's own backward kernels (in interpret mode), the kernels' tile walk (`masked_attention.tiled_reference_bwd`)
against the plain backward on masks with dead 64-key tiles, and K3b's plan
(`plan_bwd`) against the constants of the CUDA source. The kernels
themselves are checked on the card by chip_smoke.py.

Tolerances. lse: fp32 sums in another order over at most a few hundred
terms of unit scale, 1e-5. The backward: the limits of
tests/test_torch_training.py (fp32 1e-5, bf16 3e-2 of max(1, the largest
gradient)). The tile walk against the plain backward: fp32 exp2 against exp
and another summation order, 1e-5 of max(1, |ref|); bf16: the walk rounds P
and dS to bf16 as the kernels' operands (2^-9 relative each, over sums of
up to 130 terms of random sign) and both round the result once to bf16:
2^-6 of max(|ref|, rms(ref)), chip_smoke.py's BWD_TOL_BF16. The stock op
rounds P and dS to bf16 as its products' operands too, so the same limit
holds the plain backward to it in bf16, and the same backward without that
rounding fails it (by 2-5x on the mask of `_stock_mask`); in fp32, 1e-5 of
max(1, |ref|).
"""
import math
import re

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as stock

from chatterbox_embed_tpu.models import layers as jlayers
from chatterbox_embed_tpu_torch.kernels import _build
from chatterbox_embed_tpu_torch.kernels import flash_attention as tflash
from chatterbox_embed_tpu_torch.kernels import flash_attention_bwd as tbwd
from chatterbox_embed_tpu_torch.kernels import masked_attention as ma
from test_torch_masked_tiles import _OnCard
from torch_parity import t

torch.set_num_threads(2)
SOURCE = _build.CSRC / "flash_attention_bwd.cu"
BWD_TOL_BF16 = 2 * 2.0 ** -7


def _case(seed, b, tlen, h, valid, dtype):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((b, tlen, h, 64)).astype(np.float32) for _ in range(4))
    return [t(x, dtype) for x in (q, k, v, g)], t(np.asarray(valid, bool))


def _prefix(b, tlen, lens):
    return np.arange(tlen)[None, :] < np.asarray(lens)[:, None]


def _dead_tiles(b, tlen, seed):
    """Row 0 all valid, row 1 no valid key, row 2 one valid key a 64-key
    tile, row 3 its first and middle tiles dead, the rest random tiles dead
    and 70 % of the live tiles' keys valid."""
    rng = np.random.default_rng(seed)
    pos = np.arange(tlen)
    tile = pos // 64
    n = tile[-1] + 1
    valid = (rng.random((b, tlen)) < 0.7) & (rng.random((b, n)) < 0.6)[:, tile]
    valid[:, tlen - 1] |= ~valid.any(axis=1)
    valid[0] = True
    valid[1] = False
    valid[2] = pos % 64 == (5 * tile + 3) % 64
    valid[2, tlen - 1] |= not valid[2].any()
    valid[3] = (tile >= n - 1) & (tile != 1) if n > 1 else pos == tlen - 1
    return valid


def _jax_masked_scores(q, k, valid):
    """`jlayers.mha`'s logits with its key mask at -1e10, (B, H, T, T) fp32."""
    jq, jk = (jnp.asarray(x.float().numpy()) for x in (q, k))
    logits = jnp.einsum("bqhd,bkhd->bhqk", jq, jk, preferred_element_type=jnp.float32)
    logits = logits * (1.0 / math.sqrt(q.shape[-1]))
    return jnp.where(jnp.asarray(valid.numpy())[:, None, None, :], logits, jnp.float32(-1e10))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("tlen", [1, 9, 40, 130])
def test_plain_lse_matches_jax_logsumexp(dtype, tlen):
    lens = [tlen, 0, max(1, tlen // 3)]
    (q, k, _, _), valid = _case(tlen, 3, tlen, 2, _prefix(3, tlen, lens), dtype)
    lse = tflash.lse_reference(q, k, valid)
    assert lse.shape == (3, 2, tlen) and lse.dtype == torch.float32
    want = t(np.asarray(jax.nn.logsumexp(_jax_masked_scores(q, k, valid), axis=-1)))
    rows = valid.any(dim=1)
    assert (lse[rows] - want[rows]).abs().max().item() <= 1e-5
    # a row with no valid key: +inf (JAX's -1e10 mask gives -1e10 + log T
    # there), so that exp(s - lse) is exactly 0
    assert torch.isposinf(lse[1]).all()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8.0
    assert (torch.exp(s[1] - lse[1][..., None]) == 0).all()


CASES = st.integers(1, 3).flatmap(lambda b: st.tuples(
    st.just(b), st.integers(1, 70), st.integers(1, 3),
    st.lists(st.floats(0.0, 1.0), min_size=b, max_size=b), st.integers(0, 2 ** 16)))


def _close(got, want, dtype):
    scale = max(want.float().abs().max().item(), 1.0)
    rel = 1e-5 if dtype == torch.float32 else 3e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * scale, f"max|err| {err:.3e} > {rel} * {scale:.3e}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@settings(max_examples=10, deadline=None)
@given(case=CASES)
def test_lse_backward_matches_jax_vjp(dtype, case):
    """reference_dq (from the lse) and reference_dkv, and the whole plain
    backward given K3's lse and without one, against jax.vjp of
    jlayers.mha."""
    b, tlen, h, fracs, seed = case
    lens = [max(1, int(round(f * tlen))) for f in fracs]
    (q, k, v, g), valid = _case(seed, b, tlen, h, _prefix(b, tlen, lens), dtype)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jx = [jnp.asarray(x.float().numpy()).astype(jd) for x in (q, k, v, g)]
    jmask = jnp.asarray(valid.numpy())[:, None, None, :]
    out, vjp = jax.vjp(lambda q_, k_, v_: jlayers.mha(q_, k_, v_, mask=jmask), *jx[:3])
    jgrads = [t(np.asarray(x.astype(jnp.float32))) for x in vjp(jx[3])]
    out = t(np.asarray(out.astype(jnp.float32)), dtype)
    lse = tflash.lse_reference(q, k, valid)
    dq, di = tbwd.reference_dq(q, k, v, valid, out, g, lse)
    assert di.shape == lse.shape == (b, h, tlen)
    dk, dv = tbwd.reference_dkv(q, k, v, valid, g, lse, di)
    for mine, want in zip((dq, dk, dv), jgrads):
        assert mine.dtype == dtype
        _close(mine, want, dtype)
    for mine, again in zip((dq, dk, dv),
                           tbwd.flash_attention_backward_reference(q, k, v, valid, out, g)):
        assert torch.equal(mine, again)


def test_row_without_a_valid_key_gets_exact_zeros_from_the_lse():
    (q, k, v, g), valid = _case(3, 3, 20, 2, _prefix(3, 20, [20, 0, 7]), torch.float32)
    out, lse = tflash.flash_attention_with_lse(q, k, v, valid)
    assert torch.equal(out, tflash.flash_attention_reference(q, k, v, valid))
    assert torch.isposinf(lse[1]).all() and torch.isfinite(lse[[0, 2]]).all()
    dq, di = tbwd.reference_dq(q, k, v, valid, out, g, lse)
    dk, dv = tbwd.reference_dkv(q, k, v, valid, g, lse, di)
    for x in (dq, dk, dv):
        assert torch.isfinite(x).all() and not x[1].any()
    walk = ma.tiled_reference_bwd(q, k, v, valid, out, g, lse)
    for x in walk[:3]:
        assert torch.isfinite(x).all() and not x[1].any()


def _err(got, want, dtype):
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return (diff / want.float().abs().clamp_min(1.0)).max().item(), 1e-5
    floor = want.float().pow(2).mean().sqrt().item()
    return (diff / want.float().abs().clamp_min(floor)).max().item(), BWD_TOL_BF16


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("tlen", [40, 64, 65, 130, 200])
def test_tile_walk_matches_the_plain_backward(dtype, tlen):
    (q, k, v, g), valid = _case(tlen, 6, tlen, 2, _dead_tiles(6, tlen, tlen), dtype)
    out, lse = tflash.flash_attention_with_lse(q, k, v, valid)
    out = out.to(dtype)
    ref = tbwd.flash_attention_backward_reference(q, k, v, valid, out, g, lse)
    walk = ma.tiled_reference_bwd(q, k, v, valid, out, g, lse)
    for name, got, want in zip(("dq", "dk", "dv"), walk[:3], ref):
        assert got.dtype == dtype and got.shape == want.shape
        err, limit = _err(got, want, dtype)
        assert err <= limit, f"{name}: {err:.3e} > {limit}"
        assert not got[1].any()                      # the row without a valid key
    di = tbwd.reference_dq(q, k, v, valid, out, g, lse)[1]
    assert (walk[3] - di).abs().max().item() <= 1e-5
    # invalid keys get zero dk and dv (in a live tile, and every key of a dead one)
    for x in walk[1:3]:
        assert not x[~valid].any()


def _stock_mask(b, tlen):
    """Row 0 all valid, row 1 its first and third 64-key tiles dead, row 2
    one valid key a tile, row 3 the first 40 keys: every row keeps a valid
    key (the stock op's row without one is not K3's)."""
    pos = np.arange(tlen)
    tile = pos // 64
    valid = np.ones((b, tlen), bool)
    valid[1] = (tile != 0) & (tile != 2)
    valid[2] = pos % 64 == (5 * tile + 3) % 64
    valid[3] = pos < 40
    return valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_plain_backward_matches_the_stock_tpu_op(dtype):
    """The stock Pallas TPU op (forward, then its dkv and dq kernels, every
    block size given) in interpret mode, each query attending the valid keys
    (query segment 1, key segment = key_valid), against the plain backward
    and the tile walk on the same inputs, from the stock forward's output.
    In bf16 the same backward without the rounding of P and dS, in fp32 on
    the same bf16 values, must fail the limit that the rounded one meets."""
    b, tlen = 4, 256
    valid = _stock_mask(b, tlen)
    (q, k, v, g), tvalid = _case(0, b, tlen, 2, valid, dtype)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv, jg = (jnp.asarray(x.float().numpy()).astype(jd).swapaxes(1, 2)
                      for x in (q, k, v, g))
    ids = jnp.asarray(valid.astype(np.int32))
    blocks = stock.BlockSizes(
        block_q=128, block_k_major=128, block_k=128, block_b=1,
        block_q_major_dkv=128, block_k_major_dkv=128, block_k_dkv=128, block_q_dkv=128,
        block_k_major_dq=128, block_k_dq=128, block_q_dq=128)

    def op(q_, k_, v_):
        return stock.flash_attention(q_, k_, v_, segment_ids=stock.SegmentIds(
            q=jnp.ones_like(ids), kv=ids), sm_scale=0.125, block_sizes=blocks)

    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(op, jq, jk, jv)
        want = vjp(jg)
    back = (lambda x: t(np.asarray(x.swapaxes(1, 2).astype(jnp.float32)), dtype))
    out, want = back(out), [back(x) for x in want]
    lse = tflash.lse_reference(q, k, tvalid)
    plain = tbwd.flash_attention_backward_reference(q, k, v, tvalid, out, g, lse)
    walk = ma.tiled_reference_bwd(q, k, v, tvalid, out, g, lse)[:3]
    for name, p, w, s in zip(("dq", "dk", "dv"), plain, walk, want):
        for label, got in (("plain", p), ("walk", w)):
            err, limit = _err(got, s, dtype)
            assert err <= limit, f"{label} {name}: {err:.3e} > {limit}"
    if dtype == torch.bfloat16:
        exact = tbwd.flash_attention_backward_reference(
            *(x.float() for x in (q, k, v)), tvalid, out.float(), g.float(), lse)
        for name, x, s in zip(("dq", "dk", "dv"), exact, want):
            err, limit = _err(x.to(dtype), s, dtype)
            assert err > limit, f"unrounded {name}: {err:.3e} <= {limit}"


def _source_constants():
    found = dict(re.findall(r"constexpr int (kBwd\w+) = (\d+);", SOURCE.read_text()))
    return {name: int(val) for name, val in found.items()}


def test_plan_bwd_constants_equal_the_source():
    c = _source_constants()
    assert c["kBwdThreads"] == ma.BWD_THREADS == 128
    assert c["kBwdSlots"] == ma.BWD_SLOTS and c["kBwdAhead"] == ma.BWD_AHEAD
    assert c["kBwdSlots"] == c["kBwdAhead"] + 2       # a slot is rewritten two tiles on
    assert c["kBwdSlotBytes"] == ma.BWD_SLOT_BYTES == 2 * ma.STAGE_BYTES
    assert c["kBwdStatBytes"] == ma.BWD_STAT_BYTES == 2 * 4 * ma.TILE
    assert c["kBwdBlocks"] == ma.BWD_BLOCKS and c["kBwdPitch"] == ma.BWD_PITCH
    bf, f32 = ma.plan_bwd(812, torch.bfloat16), ma.plan_bwd(812, torch.float32)
    assert (bf.smem_dq, bf.smem_dkv) == (c["kBwdSmemDqTc"], c["kBwdSmemDkvTc"])
    assert (f32.smem_dq, f32.smem_dkv) == (c["kBwdSmemDqF32"], c["kBwdSmemDkvF32"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("tlen", [1, 40, 65, 812, 2348])
def test_plan_bwd_fits_the_shared_memory(dtype, tlen):
    p = ma.plan_bwd(tlen, dtype)
    assert p.tiles == -(-tlen // 64) and p.threads == 128
    for smem in (p.smem_dq, p.smem_dkv):
        assert smem < ma.SMEM_LIMIT == 232448
        # the blocks an SM the launch bounds ask for fit beside each other
        # (each block also reserves 1 KB of the SM's 228 KB)
        assert p.blocks * (smem + 1024) <= 228 * 1024
    if dtype == torch.bfloat16:
        assert p.slots == p.ahead + 2 and p.smem_dq % 1024 == 0
    else:
        assert p.slots == 0 and p.smem_dq == 5 * 64 * ma.BWD_PITCH * 4


def test_plan_bwd_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="empty"):
        ma.plan_bwd(0, torch.bfloat16)
    with pytest.raises(ValueError, match="not supported"):
        ma.plan_bwd(8, torch.float16)


def test_cuda_backward_checks_the_lse_before_any_launch(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("the call reached the build of the kernel")
    monkeypatch.setattr(_build, "load", no_build)
    x = _OnCard((4, 70, 8, 64), torch.bfloat16)
    valid = _OnCard((4, 70), torch.bool)
    for bad in (_OnCard((4, 70, 8), torch.float32), _OnCard((4, 8, 70), torch.bfloat16)):
        with pytest.raises(ValueError, match="lse"):
            tbwd.flash_attention_backward(x, x, x, valid, x, x, bad)
    assert tbwd.flash_attention_backward.launches_dq == 0
    with pytest.raises(AssertionError, match="reached the build"):
        tbwd.flash_attention_backward(x, x, x, valid, x, x, _OnCard((4, 8, 70), torch.float32))
