"""The port's rel-pos attention (kernels/rel_attention.py, K2) against the
JAX package: its plain version against the Pallas kernel in interpret mode,
and the batched conformer (>= 4 rows, the kernel branch) against JAX's
conformer with its kernel on (CHATTERBOX_PALLAS=1) and off (=0). On the CPU
the wrapper runs its plain version; the CUDA kernel itself is checked on
the card by chip_smoke.py.

Tolerances (fp32): the plain version against the JAX kernel, atol 1e-4 /
rtol 1e-3. Both agree with a float64 evaluation to ~2e-7, but on this CPU
one run in ten was once seen to differ by up to 4.9e-5 (a few hundred
products at ~2^-11 relative, as a reduced-precision matmul path would
give), and a fault of the semantics (a mask, a scale, a softmax axis) is
O(0.1). The conformer at valid positions: rtol 2e-4 / atol 2e-5
(tests/test_kernels.py:180, a few blocks deep)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import ConformerConfig
from chatterbox_embed_tpu.kernels import rel_attention as jrel
from chatterbox_embed_tpu.models import conformer as jconf
from chatterbox_embed_tpu_torch.kernels import _build
from chatterbox_embed_tpu_torch.kernels import flash_attention as tflash
from chatterbox_embed_tpu_torch.kernels import flash_decode as tfd
from chatterbox_embed_tpu_torch.kernels import rel_attention as trel
from chatterbox_embed_tpu_torch.models import conformer as tconf
from torch_parity import port_params, t

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-3)
CONF = ConformerConfig(input_size=32, output_size=32, attention_heads=4, linear_units=64,
                       num_blocks=2, num_up_blocks=1)


def _inputs(rng, b, tlen, h, da, lens):
    q = rng.standard_normal((b, tlen, h, da)).astype(np.float32) / np.sqrt(np.sqrt(da))
    k = rng.standard_normal((b, tlen, h, da)).astype(np.float32) / np.sqrt(np.sqrt(da))
    v = rng.standard_normal((b, tlen, h, 64)).astype(np.float32)
    valid = np.arange(tlen)[None, :] < np.asarray(lens)[:, None]
    return q, k, v, valid


@pytest.mark.parametrize("b,tlen,h,da,lens", [
    (3, 37, 2, 576, [37, 20, 1]),        # all valid, ragged, one valid key
    (4, 70, 2, 64, [70, 69, 33, 2]),     # K3's width, a tile edge
    (2, 130, 1, 128, [130, 64]),         # past one 128-row TPU tile
])
def test_reference_matches_jax_kernel(rng, b, tlen, h, da, lens):
    q, k, v, valid = _inputs(rng, b, tlen, h, da, lens)
    scale = 1.0 / np.sqrt(64)
    out = trel.rel_attention(t(q), t(k), t(v), t(valid), scale)
    assert trel.rel_attention.launches == 0, "CPU path counted a launch"
    ref = jrel.rel_attention(*map(jnp.asarray, (q, k, v, valid)), scale, interpret=True)
    assert out.shape == (b, tlen, h, 64) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_row_without_valid_key_gives_zero(rng):
    """As the JAX kernel: the denominator is clamped, so no NaN."""
    q, k, v, valid = _inputs(rng, 2, 20, 2, 64, [20, 0])
    out = trel.rel_attention(t(q), t(k), t(v), t(valid), 0.125)
    ref = jrel.rel_attention(*map(jnp.asarray, (q, k, v, valid)), 0.125, interpret=True)
    assert torch.isfinite(out).all()
    assert out[1].abs().max().item() == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_bf16_within_one_output_step(rng):
    """bf16 inputs: the plain version rounds once at the end (and p to bf16
    for p.v, as the JAX kernel does)."""
    q, k, v, valid = _inputs(rng, 2, 40, 2, 576, [40, 17])
    out = trel.rel_attention(*(t(a).to(torch.bfloat16) for a in (q, k, v)), t(valid), 0.125)
    ref = trel.rel_attention_reference(*(t(a).to(torch.bfloat16).float() for a in (q, k, v)),
                                       t(valid), 0.125)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-2)


def _conformer_pair():
    jp = jconf.init(jax.random.PRNGKey(1), CONF)
    return jp, port_params(tconf.init, CONF, jp, "conformer")


@pytest.mark.parametrize("pallas", ["1", "0"])
def test_batched_conformer_matches_jax(rng, monkeypatch, pallas):
    """4 ragged rows: the port takes its kernel branch (q_aug/k_aug built as
    the JAX package builds them), JAX its Pallas kernel (=1, interpret mode)
    or its factored XLA branch (=0). Valid positions only: invalid queries
    differ by design between the two JAX branches."""
    monkeypatch.setenv("CHATTERBOX_PALLAS", pallas)
    jp, tp = _conformer_pair()
    x = rng.standard_normal((4, 13, 32)).astype(np.float32)
    lens = np.array([13, 10, 6, 1], np.int32)
    ref = np.asarray(jconf.forward(jp, jnp.asarray(x), jnp.asarray(lens), CONF))
    out = tconf.forward(tp, t(x), t(lens), CONF).numpy()
    assert out.shape == (4, 26, 32)
    valid = np.arange(26)[None, :] < 2 * lens[:, None]
    np.testing.assert_allclose(out[valid], ref[valid], rtol=2e-4, atol=2e-5)


def test_batch_equals_solo_rows(rng):
    """Each row through the kernel branch equals that row alone through the
    factored branch (1 row), at valid positions: chip_smoke.py's full-width
    check, at a tiny size."""
    _, tp = _conformer_pair()
    x = rng.standard_normal((4, 11, 32)).astype(np.float32)
    lens = np.array([11, 7, 4, 9], np.int32)
    batch = tconf.forward(tp, t(x), t(lens), CONF).numpy()
    for i, n in enumerate(lens):
        solo = tconf.forward(tp, t(x[i:i + 1]), t(lens[i:i + 1]), CONF).numpy()[0]
        np.testing.assert_allclose(batch[i, :2 * n], solo[:2 * n], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("rows,kernel", [(3, False), (4, True)])
def test_gate_takes_kernel_from_four_rows(rng, monkeypatch, rows, kernel):
    """3 rows take the factored branch, 4 the kernel wrapper (one call per
    conformer block); on the CPU no launch is counted."""
    _, tp = _conformer_pair()
    calls = []
    real = tconf.rel_attention
    monkeypatch.setattr(tconf, "rel_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    x = rng.standard_normal((rows, 9, 32)).astype(np.float32)
    tconf.forward(tp, t(x), t(np.full((rows,), 9, np.int32)), CONF)
    assert len(calls) == (CONF.num_blocks + CONF.num_up_blocks if kernel else 0)
    if kernel:
        assert calls[0] == (rows, 9, 4, 8 + 32)       # [qu | A | B]: dk + d
    assert trel.rel_attention.launches == 0


def test_no_plain_fallback_off_cpu():
    """A tensor that is not on the CPU never takes the plain version: off
    the card it raises instead of returning output."""
    q = torch.empty((2, 8, 2, 576), device="meta")
    v = torch.empty((2, 8, 2, 64), device="meta")
    m = torch.empty((2, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        trel.rel_attention(q, q, v, m, 0.125)
    assert trel.rel_attention.launches == 0


@pytest.mark.parametrize("module", [trel, tflash], ids=lambda m: m.__name__.split(".")[-1])
def test_attention_kernels_build_only_with_nvcc(monkeypatch, tmp_path, module):
    """K2's and K3's sources build through kernels/_build.py, as K1's does
    (tests/test_torch_flash_decode.py); without nvcc the build raises
    rather than falling back, and nothing is written."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    assert module.SOURCE.is_file() and module.SOURCE.parent == _build.CSRC
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all([module.SOURCE])
    assert not (tmp_path / "build").exists()


def test_library_path_covers_the_shared_header():
    """K2 and K3 share csrc/masked_attention.cuh: the build key of each
    covers it, so an edit of the header rebuilds both."""
    header = _build.CSRC / "masked_attention.cuh"
    assert header.is_file()
    paths = {_build.library_path(m.SOURCE) for m in (tfd, trel, tflash)}
    assert len(paths) == 3
    assert {p.name for p in paths} == {"libflash_decode.so", "librel_attention.so",
                                       "libflash_attention.so"}
