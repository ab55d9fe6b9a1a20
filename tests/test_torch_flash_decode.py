"""The port's flash-decode attention (kernels/flash_decode.py) against the JAX
package's Pallas kernel (interpret mode) and its jnp reference, over the
cases of tests/test_kernels.py. On the CPU the port's wrapper runs its plain
PyTorch version; the CUDA kernel itself is checked on the card by
chip_smoke.py. Tolerance: fp32 throughout, atol 2e-5 / rtol 1e-4 (the JAX
kernel tests' own bound; the three differ only in summation order)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chatterbox_embed_tpu.kernels import flash_decode as jfd
from chatterbox_embed_tpu_torch.kernels import _build
from chatterbox_embed_tpu_torch.kernels import flash_decode as tfd

torch.set_num_threads(2)
TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(rng, b, l, h, d):
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((l, b, h, d)).astype(np.float32),
            rng.standard_normal((l, b, h, d)).astype(np.float32))


def _compare(q, k, v, pos, start=0, hole=None):
    launches = tfd.decode_attention.launches
    out = tfd.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), pos, start,
                               None if hole is None else torch.from_numpy(hole))
    assert tfd.decode_attention.launches == launches, "CPU path counted a launch"
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jh = None if hole is None else jnp.asarray(hole)
    kern = jfd.decode_attention(jq, jk, jv, jnp.int32(pos), jnp.int32(start),
                                hole=jh, interpret=True)
    ref = jfd.decode_attention_reference(jq, jk, jv, jnp.int32(pos), start, jh)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    return out.numpy()


@pytest.mark.parametrize("pos", [0, 1, 255, 256, 300, 511])
def test_matches_jax_kernel(rng, pos):
    _compare(*_qkv(rng, 2, 512, 4, 64), pos)


@pytest.mark.parametrize("start,pos", [(3, 40), (10, 300), (256, 400)])
def test_start_offset(rng, start, pos):
    _compare(*_qkv(rng, 2, 512, 4, 64), pos, start)


def test_multi_row(rng):
    """32 rows: the JAX kernel's multi-block feature unroll."""
    q, k, v = _qkv(rng, 32, 512, 4, 64)
    for start, pos in ((0, 77), (64, 300)):
        _compare(q, k, v, pos, start)


def test_per_row_hole(rng):
    q, k, v = _qkv(rng, 4, 512, 4, 64)
    hole = np.asarray([[0, 0], [30, 40], [250, 270], [40, 200]], np.int32)
    out = _compare(q, k, v, 310, 8, hole)
    plain = _compare(q, k, v, 310, 8)
    assert np.abs(out - plain)[1:].max() > 1e-4          # the hole bites


def test_bf16_cache_matches_fp32_reference_within_rounding(rng):
    """bf16 inputs: the plain version computes in fp32 and rounds once."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(rng, 2, 512, 16, 64))
    out = tfd.decode_attention(q, k, v, 381, 4)
    ref = tfd.decode_attention_reference(q.float(), k.float(), v.float(), 381, 4)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


def test_no_plain_fallback_off_cpu(rng):
    """A tensor that is not on the CPU never takes the plain version: off
    the card it raises instead of returning output."""
    q, k, v = (torch.empty(s, device="meta") for s in ((2, 16, 64), (512, 2, 16, 64),
                                                        (512, 2, 16, 64)))
    with pytest.raises(ValueError, match="unsupported device"):
        tfd.decode_attention(q, k, v, 10, 0)
    assert tfd.decode_attention.launches == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The kernel is built only by nvcc from csrc/ (kernels/_build.py, the
    route of every kernel); without one the build raises rather than
    falling back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(tfd.SOURCE)
    assert not (tmp_path / "build").exists()


def test_library_path_keyed_by_source():
    p = _build.library_path(tfd.SOURCE)
    assert p.parent.parent == _build.BUILD_ROOT and p.name == "libflash_decode.so"
    assert tfd.SOURCE.is_file() and tfd.SOURCE.suffix == ".cu"
