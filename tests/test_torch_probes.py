"""The plain PyTorch versions of the two probe kernels (K5 weight stream, K6
decode anatomy) against the bodies of the Pallas TPU kernels they replace,
run on the CPU in interpret mode: `pl.pallas_call(..., interpret=True)` on
`_kernel` / `_variant_kernel` imported from `scripts/` (the scripts' jitted
wrappers take no interpret flag; the DMA primitives do interpret in this
JAX). And: the port's kernel wrappers and probe entry points raise without a
CUDA card and never return the plain result.

Tolerances. K5 bf16: products of bf16 values are exact in fp32; the two
sides add n = rows / 128 * 1024 of them per output in another order, so
they differ by about eps * sqrt(n) * |partial sums|: atol 2^-23 * n * 0.6
(0.6 ~ the rms of a product of a unit normal and a uniform weight), the
bound chip_smoke.py uses on the card. K5 int8: exact integers, equal. K6:
fp32 attention in another order, atol 1e-5 on outputs of O(1); bf16 inputs
round the output to bf16 on both sides, one step (2e-2). load_only adds at
most 6 rows: equal up to one rounding of the output dtype.

compute_only: the TPU variant reads a scratch buffer that nothing filled,
so its output is not defined (in interpret mode the scratch holds whatever
the interpreter allocates). The port defines it as attention over chunk 0
repeated; its plain version is held to a numpy restatement of the TPU
kernel's compute() applied to chunk 0, not to the Pallas call."""
import functools
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from chatterbox_embed_tpu_torch.kernels import decode_anatomy as tda
from chatterbox_embed_tpu_torch.kernels import weight_stream as tws
from chatterbox_embed_tpu_torch.probes import decode_anatomy as pda
from chatterbox_embed_tpu_torch.probes import timing
from chatterbox_embed_tpu_torch.probes import weight_stream as pws

torch.set_num_threads(2)
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jws():
    return _script("microbench_weight_stream")


@pytest.fixture(scope="module")
def jda():
    return _script("microbench_decode_anatomy")


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def _pallas_stream_once(jws, x, w, nbuf):
    rows = w.shape[1]
    return pl.pallas_call(
        functools.partial(jws._kernel, nbuf),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((nbuf, rows, jws.D), w.dtype),
                        pltpu.VMEM((8, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA((nbuf,))],
        interpret=True)(x, w)


@pytest.mark.parametrize("tag", ["bf16", "int8"])
@pytest.mark.parametrize("n_chunks,rows,nbuf", [(3, 256, 2), (5, 128, 4), (2, 512, 2)])
def test_weight_stream_plain_matches_the_pallas_body(jws, tag, n_chunks, rows, nbuf):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if tag == "bf16" else (jnp.int8, torch.int8)
    rng = np.random.default_rng(n_chunks * rows)
    x = jnp.asarray(rng.standard_normal((8, jws.D)) * (3.0 if tag == "int8" else 1.0),
                    jnp.bfloat16)
    w = jws._make_w(n_chunks, rows, jdt)
    ref = np.asarray(_pallas_stream_once(jws, x, w, nbuf))
    wall = tws.make_wall(n_chunks, rows, tdt, "cpu")
    # the same wall on both sides, from the same integer formula
    np.testing.assert_array_equal(wall.float().numpy(), np.asarray(w.astype(jnp.float32)))
    out = tws.stream_once_reference(_to_torch(x, torch.bfloat16), wall).numpy()
    assert out.shape == (8, 128) and out.dtype == np.float32
    if tag == "int8":
        assert np.abs(ref).max() > 1000                   # x truncates to non-zero integers
        np.testing.assert_array_equal(out, ref)
    else:
        n = n_chunks * rows // 128 * jws.D
        np.testing.assert_allclose(out, ref, atol=2.0 ** -23 * n * 0.6)


def test_weight_stream_sweep_is_the_scripts(jws):
    import inspect
    src = inspect.getsource(jws.main)
    assert "((1, 2), (1, 4), (2, 2), (2, 4), (4, 2))" in src
    assert set(pws.BF16_SWEEP) >= {(1, 2), (1, 4), (2, 2), (2, 4), (4, 2)}
    assert pws.INT8_SWEEP == ((1, 2), (1, 4), (2, 2))     # the script stops after (2, 2)
    assert pws.TOTAL_MB == jws.TOTAL_MB and tws.D == jws.D
    # every swept slab splits over the grid into a compiled stage height
    for item, sweep in ((2, pws.BF16_SWEEP), (1, pws.INT8_SWEEP)):
        for slab_mb, _ in sweep:
            rows = (slab_mb << 20) // (tws.D * item)
            assert rows % tws.BLOCKS == 0 and rows // tws.BLOCKS in tws.ROWS_PER_BLOCK


def _pallas_attn(jda, q, k, v, pos, mode, f, total):
    """`attn`'s pallas_call at a small F and cache, interpreted."""
    return pl.pallas_call(
        functools.partial(jda._variant_kernel, mode),
        out_shape=jax.ShapeDtypeStruct((1, f), q.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM), pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((2, jda.CHUNK, f), k.dtype),
                        pltpu.VMEM((2, jda.CHUNK, f), v.dtype),
                        pltpu.SemaphoreType.DMA((2, 2))],
        interpret=True)(jnp.asarray([pos], jnp.int32), q, k, v)


def _qkv(seed, f, total, jdt):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.standard_normal((1, f)), jdt),
            jnp.asarray(rng.standard_normal((total, f)), jdt),
            jnp.asarray(rng.standard_normal((total, f)), jdt))


@pytest.mark.parametrize("tag", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [44, 379])                 # 1 chunk and 6, as the script
@pytest.mark.parametrize("mode,jmode", [("full", "full"), ("load_only", "dma_only")])
def test_decode_anatomy_plain_matches_the_pallas_body(jda, mode, jmode, pos, tag):
    jdt, tdt = (jnp.float32, torch.float32) if tag == "float32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    f, total = jda.FBLK, 512                               # one 4096-feature block: 64 groups
    q, k, v = _qkv(pos, f, total, jdt)
    ref = np.asarray(_pallas_attn(jda, q, k, v, pos, jmode, f, total).astype(jnp.float32))
    out = tda.attn_reference(_to_torch(q, tdt), _to_torch(k, tdt), _to_torch(v, tdt), pos, mode)
    assert out.dtype == tdt and tuple(out.shape) == (1, f)
    atol = {"float32": 1e-5, "bfloat16": 2e-2}[tag]
    if mode == "load_only" and tag == "bfloat16":
        atol = 2.0 ** -7 * np.abs(ref).max()               # one bf16 step of the largest sum
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol)
    assert tda.CHUNK == jda.CHUNK and tda.HEAD_DIM == jda.D


def _numpy_compute_only(q, k, v, pos, chunk=64, d=64):
    """The TPU kernel's compute() folded over n_chunks steps, each on chunk
    0 of the cache (what its compute_only variant would read from a filled
    slot 0): online softmax per group of d features, fp64."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    f = q.shape[1]
    g = f // d
    n_chunks = (pos + chunk) // chunk
    m = np.full((1, g), -1e30)
    l = np.zeros((1, g))
    acc = np.zeros((1, f))
    k0, v0 = k[:chunk], v[:chunk]
    for c in range(n_chunks):
        in_range = (c * chunk + np.arange(chunk)[:, None]) <= pos
        logits = (q * k0).reshape(chunk, g, d).sum(-1) / math.sqrt(d)
        logits = np.where(in_range, logits, -1e30)
        m_new = np.maximum(m, logits.max(0, keepdims=True))
        p = np.exp(logits - m_new) * in_range
        alpha = np.exp(m - m_new)
        l = l * alpha + p.sum(0, keepdims=True)
        acc = acc * np.repeat(alpha, d, 1) + (np.repeat(p, d, 1) * v0).sum(0, keepdims=True)
        m = m_new
    return acc / (np.repeat(l, d, 1) + 1e-9)


@pytest.mark.parametrize("pos", [0, 44, 63, 64, 379])
def test_decode_anatomy_compute_only_is_attention_over_chunk_0_repeated(pos):
    q, k, v = (np.asarray(a) for a in _qkv(7 + pos, 256, 512, jnp.float32))
    out = tda.attn_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             pos, "compute_only").numpy()
    np.testing.assert_allclose(out, _numpy_compute_only(q, k, v, pos), atol=1e-5)
    # and the full mode against the same restatement on the real rows
    full = tda.attn_reference(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              pos, "full").numpy()
    if pos < 64:
        np.testing.assert_allclose(full, out, atol=1e-6)   # one chunk: the same slots


def test_decode_anatomy_probe_shape_is_the_scripts(jda):
    assert (pda.B, pda.H, pda.D, pda.TOTAL, pda.F) == (jda.B, jda.H, jda.D, jda.TOTAL, jda.F)
    assert pda.POSITIONS == ((44, "1chunk"), (379, "6chunk"))
    assert set(pda.SCRIPT_KEY.values()) == {"full", "dma_only", "compute_only"}
    assert tuple(pda.SCRIPT_KEY) == tda.MODES and pda.STEPS == (1024, 4096)


def test_wrappers_raise_without_a_card_and_never_return_the_plain_result(monkeypatch):
    """A CPU tensor is refused by both wrappers: the plain versions are not
    a fallback. The probe entry points and the timers refuse a machine
    without a card."""
    x = torch.zeros((8, 1024), dtype=torch.bfloat16)
    w = tws.make_wall(2, 512, torch.bfloat16, "cpu")
    before = tws.stream_once.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tws.stream_once(x, w, 2)
    q, k, v = torch.zeros((1, 128)), torch.zeros((128, 128)), torch.zeros((128, 128))
    for mode in tda.MODES:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            tda.attn(q, k, v, 3, mode)
    with pytest.raises(ValueError, match="not in"):
        tda.attn(q, k, v, 3, "dma_only")
    assert tws.stream_once.launches == before and tda.attn.launches == 0
    assert tws.stream_once_reference(x, w).shape == (8, 128)     # the plain one does run here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (pws.run, pda.run, pws.main, pda.main, timing.require_cuda,
               lambda: timing.time_ms(lambda: None), lambda: timing.device_ms(lambda: None)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            fn()


def test_make_wall_values():
    """The wall's values: int8 spans [-128, 127], bf16 holds v / 128 exactly;
    a CPU tensor is refused before any other argument is looked at."""
    x = torch.zeros((8, 1024), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tws.stream_once(x.float(), tws.make_wall(1, 512, torch.int8, "cpu"), 9)
    wall = tws.make_wall(2, 128, torch.int8, "cpu")
    assert wall.dtype == torch.int8 and int(wall.min()) == -128 and int(wall.max()) == 127
    assert float(tws.make_wall(1, 128, torch.bfloat16, "cpu").abs().max()) == 1.0
