"""The algorithm of the port's decode walk (csrc/decode_walk.cuh, under K1 /
K1s flash_decode, K4 fused_decode and the K6 probe), walked in plain PyTorch
on the CPU (kernels/flash_decode.py:walk_reference: live-range splits, a
softmax max per tile, per-split partials, the merge by the last block, K1s's
fold), against the plain version and the JAX package's Pallas kernel in
interpret mode; and the split constants of the CUDA headers against their
Python mirror. The CUDA kernels themselves are checked on the card by
chip_smoke.py.

Tolerance: fp32, atol 2e-5 / rtol 1e-4, as tests/test_torch_flash_decode.py
(the versions differ in summation order and in exp2(x * log2 e) against
exp(x)). bf16 inputs: both compute in fp32 and round once: 2e-2."""
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from hypothesis import given, settings, strategies as st

from chatterbox_embed_tpu.kernels import flash_decode as jfd
from chatterbox_embed_tpu_torch.kernels import _build
from chatterbox_embed_tpu_torch.kernels import flash_decode as tfd
from chatterbox_embed_tpu_torch.kernels import fused_decode as tfu

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=1e-4)
D = 64


def _inputs(rng, b, h, lc, layers=None):
    lead = () if layers is None else (layers,)
    q = rng.standard_normal((b, h, D)).astype(np.float32)
    k, v = (rng.standard_normal(lead + (lc, b, h, D)).astype(np.float32) for _ in range(2))
    kc, vc = (rng.standard_normal((b, h, D)).astype(np.float32) for _ in range(2))
    return q, k, v, kc, vc


def _walk_and_plain(q, k, v, kc, vc, pos, start, hole, deferred, layer=None):
    th = None if hole is None else torch.tensor(hole, dtype=torch.int32)
    kw = dict(layer=layer)
    if deferred:
        kw.update(k_cur=torch.from_numpy(kc), v_cur=torch.from_numpy(vc))
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos, start, th)
    return tfd.walk_reference(*args, **kw), tfd.decode_attention_reference(*args, **kw)


# (B, H, Lc, start, pos, hole, deferred): pos = start; fewer live slots than
# splits (the last splits empty); a hole over the first splits and across
# split edges; Lc 1280 at the smoke's two row counts (B*H = 32: 16 splits;
# B*H = 64: 8); one utterance's 8 heads on a tp = 2 rank (B*H = 16: 16
# splits at Lc 512, 32 at 1280)
CASES = [
    (2, 16, 512, 0, 0, None, False),
    (2, 16, 512, 7, 7, None, True),
    (2, 16, 512, 300, 305, None, False),
    (2, 16, 512, 72, 205, [[0, 0], [70, 200]], False),
    (2, 16, 512, 10, 381, [[30, 47], [100, 164]], True),
    (16, 4, 1280, 4, 964, [[70 + 3 * r, 75 + 5 * r] for r in range(16)], False),
    (2, 16, 1280, 5, 1279, [[0, 0], [600, 700]], True),
    (1, 2, 256, 3, 255, [[9, 33]], False),
    (2, 8, 512, 4, 381, [[0, 0], [70, 200]], False),
    (2, 8, 1280, 4, 964, [[30, 47], [600, 700]], False),
]


@pytest.mark.parametrize("b,h,lc,start,pos,hole,deferred", CASES)
def test_walk_matches_plain_and_jax_kernel(rng, b, h, lc, start, pos, hole, deferred):
    layer = 1 if deferred else None
    q, k, v, kc, vc = _inputs(rng, b, h, lc, 3 if deferred else None)
    walk, plain = _walk_and_plain(q, k, v, kc, vc, pos, start, hole, deferred, layer)
    np.testing.assert_allclose(walk.numpy(), plain.numpy(), **TOL)
    jh = None if hole is None else jnp.asarray(hole, jnp.int32)
    extra = (dict(layer=jnp.int32(layer), k_cur=jnp.asarray(kc), v_cur=jnp.asarray(vc))
             if deferred else {})
    kern = jfd.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jnp.int32(pos), jnp.int32(start), hole=jh, interpret=True,
                                **extra)
    np.testing.assert_allclose(walk.numpy(), np.asarray(kern), **TOL)


@settings(max_examples=60, deadline=None)
@given(b=st.integers(1, 4), lc=st.sampled_from([64, 96, 512, 1280]),
       data=st.data(), deferred=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_walk_on_arbitrary_ranges_and_holes(b, lc, data, deferred, seed):
    start = data.draw(st.integers(0, lc - 1))
    pos = data.draw(st.integers(start, lc - 1))
    # one hole per row anywhere (across split edges, over the whole walk);
    # a row keeps at least one live slot unless the current row is folded in
    hole = []
    for _ in range(b):
        lo = data.draw(st.integers(0, lc))
        hole.append([lo, data.draw(st.integers(lo, lc))])
    if not deferred:
        for r in range(b):
            lo, hi = hole[r]
            if lo <= start and hi > pos:
                hole[r] = [0, 0]
    rng = np.random.default_rng(seed)
    q, k, v, kc, vc = _inputs(rng, b, 2, lc)
    walk, plain = _walk_and_plain(q, k, v, kc, vc, pos, start, hole, deferred)
    np.testing.assert_allclose(walk.numpy(), plain.numpy(), **TOL)


def test_bf16_walk_takes_the_bf16_tile(rng):
    q, k, v, kc, vc = (torch.from_numpy(a).to(torch.bfloat16)
                       for a in _inputs(rng, 2, 16, 512))
    out = tfd.walk_reference(q, k, v, 381, 4, None, k_cur=kc, v_cur=vc)
    ref = tfd.decode_attention_reference(q.float(), k.float(), v.float(), 381, 4,
                                         k_cur=kc.float(), v_cur=vc.float())
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)
    # the bf16 schedule walks tiles of 128 keys, fp32 of 64: the same function
    f32 = tfd.walk_reference(q.float(), k.float(), v.float(), 381, 4, None,
                             k_cur=kc.float(), v_cur=vc.float())
    np.testing.assert_allclose(out.float().numpy(), f32.numpy(), atol=2e-2)


@pytest.mark.parametrize("start,walk_end", [(0, 0), (4, 3), (4, 10), (0, 511), (72, 204),
                                            (300, 305), (5, 1278)])
@pytest.mark.parametrize("n_splits", [1, 2, 8, 16, 40])
def test_splits_cover_the_live_range_in_order(start, walk_end, n_splits):
    covered = []
    for s in range(n_splits):
        lo, hi = tfd.split_range(start, walk_end, n_splits, s)
        if lo <= hi:
            assert lo >= start and hi <= walk_end
            covered.extend(range(lo, hi + 1))
    assert covered == list(range(start, walk_end + 1))


def _constants(path):
    text = path.read_text()
    return {name: int(val) for name, val in
            re.findall(r"constexpr (?:int|size_t) (k\w+) = (\d+)", text)}, text


def test_split_constants_equal_the_headers():
    walk, text = _constants(_build.CSRC / "decode_walk.cuh")
    assert walk["kSplitWarps"] == tfd.SPLIT_WARPS
    assert walk["kSplitBlocks"] == tfd.SPLIT_BLOCKS
    assert walk["kMinSplitKeys"] == tfd.MIN_SPLIT_KEYS
    assert walk["kHeadDim"] == tfd.HEAD_DIM == D
    assert 32 // walk["kGroupLanes"] == tfd.GROUPS          # kGroups = 32 / kGroupLanes
    loads = re.findall(r"struct Row<(\w+)> \{\s*static constexpr int kLoads = (\d+);", text)
    names = {"__nv_bfloat16": torch.bfloat16, "float": torch.float32}
    # the int8 walk (flash_decode.cu): a ring of kInt8Stages tiles of
    # kInt8Tile keys, kInt8Slots = kInt8Tile / (kWarps * kGroups) a warp
    int8, fd_text = _constants(_build.CSRC / "flash_decode.cu")
    assert int8["kInt8Tile"] == tfd.INT8_TILE
    assert int8["kInt8Stages"] == tfd.INT8_STAGES
    assert int8["kInt8Blocks"] == tfd.INT8_BLOCKS
    assert "constexpr int kWarps = kSplitWarps;" in fd_text
    assert "constexpr int kInt8Slots = kInt8Tile / (kWarps * kGroups);" in fd_text
    assert "__launch_bounds__(kThreads, kInt8Blocks)" in fd_text
    slots = int8["kInt8Tile"] // (walk["kSplitWarps"] * (32 // walk["kGroupLanes"]))
    assert {**{names[t]: int(n) for t, n in loads}, torch.int8: slots} == tfd.LOADS
    fused, _ = _constants(_build.CSRC / "fused_decode.cu")
    assert fused["kMaxSplits"] == tfu.MAX_SPLITS


@pytest.mark.parametrize("b,h,lc,want", [(2, 16, 512, 16), (2, 16, 1280, 16), (16, 16, 512, 2),
                                         (16, 16, 1280, 2), (1, 16, 512, 16), (64, 16, 512, 1),
                                         (2, 2, 64, 2), (2, 8, 512, 16), (2, 8, 1280, 32)])
def test_split_count_fills_the_card(b, h, lc, want):
    """kSplitBlocks / (B*H) rounded up, capped at Lc / kMinSplitKeys: 512
    blocks (~4 on each of the H100's 132 SMs) at B = 2 and 16."""
    s = tfd.splits_for(b * h, lc)
    assert s == want
    if h == 16 and b in (2, 16):
        assert b * h * s == tfd.SPLIT_BLOCKS


def test_workspace_is_made_once_per_shape():
    a = tfd.workspace(torch.device("cpu"), torch.bfloat16, 2, 16, 512)
    again = tfd.workspace(torch.device("cpu"), torch.bfloat16, 2, 16, 512)
    assert a[0] is again[0] and a[1] is again[1]
    assert a[0].numel() == 2 * 16 * 16 * (D + 2) and a[0].dtype == torch.float32
    assert a[1].dtype == torch.int32 and not a[1].any()
    other = tfd.workspace(torch.device("cpu"), torch.bfloat16, 16, 16, 512)
    assert other[0].numel() == 16 * 16 * 2 * (D + 2)
