"""The port's Llama (models/llama.py) against the JAX package's
llama.forward: prefill into the static cache, then decode steps that insert
first and attend through decode_attention. The JAX side runs once on its XLA
decode path and once through its Pallas flash-decode kernel in interpret
mode. Sizes satisfy that kernel's asserts (Lc a multiple of 256, B*H*D = 128).
Tolerance 1e-4 (fp32; summation order only)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import LlamaConfig
from chatterbox_embed_tpu.models import llama as jl
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.models import llama as tl
from chatterbox_embed_tpu_torch.weights import convert_tree

torch.set_num_threads(2)
CFG = LlamaConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                  num_heads=4, num_kv_heads=4, head_dim=16)
B, P, PAD, TOTAL, STEPS = 2, 21, 3, 256, 5
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jl.init(jax.random.PRNGKey(0), CFG)
    tp = convert_tree(tl.init(L.Init(device="meta"), CFG), jp, "llama")
    return jp, tp


def test_rope_tables_match():
    np.testing.assert_array_equal(tl._scaled_inv_freq(CFG), jl._scaled_inv_freq(CFG))
    pos = np.arange(40, dtype=np.int32).reshape(2, 20)
    jc, js = jl.rope_cos_sin(jnp.asarray(pos), CFG)
    tc, ts = tl.rope_cos_sin(torch.from_numpy(pos), CFG)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("jax_path", ["xla", "pallas_interpret"])
def test_prefill_and_decode_match_jax(params, jax_path):
    jp, tp = params
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, P + STEPS, CFG.hidden_size)).astype(np.float32)
    idx = np.arange(P)
    kidx = np.arange(TOTAL)
    mask = ((kidx[None] <= idx[:, None]) & (kidx[None] >= PAD))[None]
    pos = np.broadcast_to(np.maximum(np.arange(P + STEPS) - PAD, 0)[None], (B, P + STEPS))
    pos = np.ascontiguousarray(pos).astype(np.int32)

    jh, jcache = jl.forward(jp, jnp.asarray(x[:, :P]), jnp.asarray(pos[:, :P]),
                            jnp.asarray(mask), cache=jl.init_cache(CFG, B, TOTAL),
                            cache_pos=0, cfg=CFG)
    th, tcache = tl.forward(tp, torch.from_numpy(x[:, :P]), torch.from_numpy(pos[:, :P]),
                            torch.from_numpy(mask), cache=tl.init_cache(CFG, B, TOTAL, device="cpu"),
                            cache_pos=0, cfg=CFG)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **TOL)

    for i in range(STEPS):
        cp = P + i
        lmask = ((kidx <= cp) & (kidx >= PAD))[None, None]
        jh, jcache = jl.forward(jp, jnp.asarray(x[:, cp:cp + 1]), jnp.asarray(pos[:, cp:cp + 1]),
                                jnp.asarray(lmask), cache=jcache, cache_pos=cp, cfg=CFG,
                                flash_decode=jax_path != "xla", flash_start=PAD)
        th, tcache = tl.forward(tp, torch.from_numpy(x[:, cp:cp + 1]),
                                torch.from_numpy(pos[:, cp:cp + 1]), cache=tcache,
                                cache_pos=cp, cfg=CFG, flash_start=PAD)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), **TOL)


def test_decode_equals_full_causal_forward(params):
    """Port-internal: decode steps against the in-place cache give the
    hidden states of one causal forward over the whole sequence."""
    _, tp = params
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((B, P + STEPS, CFG.hidden_size)).astype(np.float32))
    pos = torch.arange(P + STEPS)[None].expand(B, -1)
    _, cache = tl.forward(tp, x[:, :P], pos[:, :P], cache=tl.init_cache(CFG, B, TOTAL, device="cpu"), cfg=CFG)
    steps = []
    for i in range(STEPS):
        h, cache = tl.forward(tp, x[:, P + i:P + i + 1], pos[:, P + i:P + i + 1],
                              cache=cache, cache_pos=P + i, cfg=CFG)
        steps.append(h)
    full, _ = tl.forward(tp, x, pos, cfg=CFG)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full[:, P:].numpy(), **TOL)
