"""The port's key-masked self-attention (kernels/flash_attention.py, K3)
against the JAX package: its plain version against JAX's `layers.mha` with
a key mask, and the CFM estimator at >= 4 rows (the kernel branch) against
JAX's estimator. JAX's own flash kernel (the stock Pallas TPU op behind
`mha_flash`) has no CPU path, so on the CPU its estimator runs `layers.mha`
at every row count, which is what the port's kernel is held to. On the CPU
the port's wrapper runs its plain version; the CUDA kernel itself is
checked on the card by chip_smoke.py.

Tolerances (fp32): atol 1e-4 / rtol 1e-3 for the attention against JAX
(the reason is in tests/test_torch_rel_attention.py; a fault of the
semantics is O(0.1)), 1e-4 for the estimator (the bound of
tests/test_torch_s3gen.py)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import FlowDecoderConfig
from chatterbox_embed_tpu.models import flow_decoder as jfd
from chatterbox_embed_tpu.models import layers as jlayers
from chatterbox_embed_tpu_torch.kernels import flash_attention as tflash
from chatterbox_embed_tpu_torch.models import flow_decoder as tfd
from chatterbox_embed_tpu_torch.models import layers as L
from torch_parity import port_params, t

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-3)
DEC = FlowDecoderConfig(in_channels=32, out_channels=8, channels=16, attention_head_dim=8,
                        num_heads=2, n_blocks=1, num_mid_blocks=2, time_embed_dim=64)


def _qkv(rng, b, tlen, h, d):
    return tuple(rng.standard_normal((b, tlen, h, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("b,tlen,lens", [
    (4, 37, [37, 20, 1, 36]),          # all valid, ragged, one valid key
    (3, 130, [130, 64, 65]),           # past two 64-key tiles
])
def test_reference_matches_jax_mha(rng, b, tlen, lens):
    q, k, v = _qkv(rng, b, tlen, 2, 64)
    valid = np.arange(tlen)[None, :] < np.asarray(lens)[:, None]
    out = tflash.flash_attention(t(q), t(k), t(v), t(valid))
    assert tflash.flash_attention.launches == 0, "CPU path counted a launch"
    ref = jlayers.mha(*map(jnp.asarray, (q, k, v)), mask=jnp.asarray(valid)[:, None, None, :])
    assert out.shape == (b, tlen, 2, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_mha_flash_without_mask_is_mha(rng):
    q, k, v = _qkv(rng, 4, 21, 2, 64)
    np.testing.assert_array_equal(L.mha_flash(t(q), t(k), t(v)).numpy(),
                                  L.mha(t(q), t(k), t(v)).numpy())


def _flow_inputs(rng, b, tlen=20):
    x, mu, cond = (rng.standard_normal((b, tlen, 8)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((b, 8)).astype(np.float32)
    lens = np.array([tlen, 14, 3, 9, 20, 1][:b])
    mask = (np.arange(tlen)[None, :, None] < lens[:, None, None]).astype(np.float32)
    tt = rng.uniform(0, 1, (b,)).astype(np.float32)
    return x, mu, tt, spks, cond, mask


@pytest.mark.parametrize("rows", [4, 6])
def test_batched_estimator_matches_jax(rng, rows):
    jp = jfd.init(jax.random.PRNGKey(2), DEC)
    tp = port_params(tfd.init, DEC, jp, "flow_decoder")
    args = _flow_inputs(rng, rows)
    ref = np.asarray(jfd.forward(jp, *map(jnp.asarray, args), cfg=DEC))
    out = tfd.forward(tp, *map(t, args), cfg=DEC).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("rows,kernel", [(3, False), (4, True)])
def test_gate_takes_kernel_from_four_rows(rng, monkeypatch, rows, kernel):
    """3 rows write attention out (layers.mha), 4 go through the kernel
    wrapper, once per transformer block; on the CPU no launch is counted."""
    jp = jfd.init(jax.random.PRNGKey(2), DEC)
    tp = port_params(tfd.init, DEC, jp, "flow_decoder")
    calls = []
    real = L.flash_attention
    monkeypatch.setattr(L, "flash_attention", lambda *a: calls.append(a[0].shape) or real(*a))
    tfd.forward(tp, *map(t, _flow_inputs(rng, rows)), cfg=DEC)
    n_tblocks = (2 + DEC.num_mid_blocks) * DEC.n_blocks
    assert len(calls) == (n_tblocks if kernel else 0)
    assert tflash.flash_attention.launches == 0


def test_no_plain_fallback_off_cpu():
    q = torch.empty((4, 8, 2, 64), device="meta")
    m = torch.empty((4, 8), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tflash.flash_attention(q, q, q, m)
    assert tflash.flash_attention.launches == 0
