"""int8 in the PyTorch port (ROADMAP item 22) against the JAX package:
int8 weights (utils/quantize.py over layers.quantize_linear, the w_q branch
of layers.linear), the int8 KV cache (CHATTERBOX_INT8_KV=1: the writes in
models/llama.py, K1's and K1s's int8 entry in kernels/flash_decode.py), the
engine's int8 cache, the fence that counts the scale planes, and the JAX
package's phased run, which the port decodes in one phase.

The JAX side runs as its own tests run it on the CPU: XLA, where its int8
cache is read (mode 1: the scales factored out of both dots). The port's
decode takes K1's plain version (its int8 formula is the JAX mode-1 one),
so tokens are compared through JAX's own Gumbel draws (`JaxDraws`).

Tolerances. Quantising is exact arithmetic on equal inputs, so trees
quantised in either package are equal bit for bit. An int8 slab written
from k/v that the two packages computed in another summation order may
differ by 1 where a value lies at a rounding boundary (at most 0.1 % of the
entries here), and its scale by fp32 rounding (1e-6 relative). Logits and
hidden states: 1e-4 after a prefill or a decode, 1e-5 for one decode step
on equal caches (fp32 sums in another order). The quality bounds of
tests/test_int8.py (int8 against fp on the same backbone) are theirs.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu.config import (ConformerConfig, FlowDecoderConfig, HiFTConfig,
                                         S3GenConfig, S3TokenizerConfig, replace)
from chatterbox_embed_tpu.models import layers as JL
from chatterbox_embed_tpu.models import llama as jllama
from chatterbox_embed_tpu.models import s3gen as js3gen
from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu.models import t3_engine as jeng
from chatterbox_embed_tpu.utils import quantize as jq
from chatterbox_embed_tpu_torch.kernels import flash_decode as tfd
from chatterbox_embed_tpu_torch.models import layers as TL
from chatterbox_embed_tpu_torch.models import llama as tllama
from chatterbox_embed_tpu_torch.models import s3gen as ts3gen
from chatterbox_embed_tpu_torch.models import t3 as tt3
from chatterbox_embed_tpu_torch.models import t3_engine as teng
from chatterbox_embed_tpu_torch.utils import quantize as tq
from chatterbox_embed_tpu_torch.weights import _leaves
from test_torch_t3 import TINY
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)

S3_TINY = S3GenConfig(
    flow=replace(S3GenConfig().flow,
                 encoder=ConformerConfig(input_size=32, output_size=32, attention_heads=4,
                                         linear_units=64, num_blocks=1, num_up_blocks=1),
                 decoder=FlowDecoderConfig(in_channels=32, out_channels=8, channels=16,
                                           attention_head_dim=8, num_heads=2, n_blocks=1,
                                           num_mid_blocks=1, time_embed_dim=64),
                 input_size=32, output_size=8),
    hift=HiFTConfig(in_channels=8, base_channels=32, f0_cond_channels=16),
    tokenizer=S3TokenizerConfig(n_state=64, n_heads=4, n_layers=1),
    mel_num=8)


@pytest.fixture(scope="module")
def t3_pair():
    """JAX T3 params and their int8 tree, and the port's of both."""
    jp = jt3.init(jax.random.PRNGKey(0), TINY)
    jqp = jq.quantize_t3(jax.tree.map(np.asarray, jp))
    return jp, jqp, port_params(tt3.init, TINY, jp, "T3"), port_params(tt3.init, TINY, jqp, "T3")


@pytest.fixture(scope="module")
def s3_pair():
    jp = js3gen.init(jax.random.PRNGKey(7), S3_TINY)
    jqp = jq.quantize_s3gen(jax.tree.map(np.asarray, jp))
    return (jp, jqp, port_params(ts3gen.init, S3_TINY, jp, "S3Gen"),
            port_params(ts3gen.init, S3_TINY, jqp, "S3Gen"))


@pytest.fixture(autouse=True)
def _xla_decode(monkeypatch):
    for key in ("CHATTERBOX_INT8_KV", "CHATTERBOX_DEFER_KV", "CHATTERBOX_PHASED_CACHE",
                "CHATTERBOX_MAX_DECODE_UTT", "CHATTERBOX_FUSED_STEP"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("CHATTERBOX_PALLAS", "0")


def _cond(rng):
    spk = rng.standard_normal((1, 16)).astype(np.float32)
    prompt = rng.integers(0, 36, (1, 6)).astype(np.int32)
    return (jt3.T3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5),
            tt3.T3Cond(t(spk), t(prompt), 0.5))


def _ragged(rng, lens, lt=12):
    rows = np.zeros((len(lens), lt), np.int32)
    for i, n in enumerate(lens):
        rows[i, :n] = rng.integers(1, 50, (n,))
        rows[i, 0] = 5
        rows[i, n - 1] = 0
    return rows, np.asarray(lens, np.int32)


def _cos_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b))
    return cos, np.linalg.norm(a - b) / np.linalg.norm(a)


# ---------------------------------------------------------------------------
# 1-3: int8 weights
# ---------------------------------------------------------------------------

def _assert_trees_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, x in got.items():
        y = want[path]
        assert x.dtype == y.dtype, path
        assert torch.equal(x, y), path


def test_quantize_t3_equals_the_jax_packages_bit_for_bit(t3_pair):
    _, _, tp, tqp = t3_pair
    got = tq.quantize_t3(tp)
    _assert_trees_bit_equal(got, tqp)
    lin = got["llama"]["layers"][0]["down"]
    assert lin["w_q"].dtype == torch.int8 and lin["scale"].shape == (1, TINY.hidden_size)
    assert "w" in got["speech_head"] and "w" in got["cond_enc"]["perceiver"]["q"]


def test_quantize_s3gen_equals_the_jax_packages_bit_for_bit(s3_pair):
    _, _, tp, tqp = s3_pair
    got = tq.quantize_s3gen(tp)
    _assert_trees_bit_equal(got, tqp)
    blk = got["flow"]["encoder"]["blocks"][0]
    assert "w_q" in blk["q"] and "w" in blk["pos"]        # K2 reads pos raw
    assert "w_q" in got["flow"]["decoder"]["down"]["resnet"]["mlp"]


def test_int8_leaves_are_checked_and_kept(t3_pair):
    """from_jax_params keeps w_q int8 and scale fp32, and place keeps them;
    a w_q of another dtype or shape, or a stray leaf, still raises."""
    from chatterbox_embed_tpu_torch.weights import place
    _, jqp, _, tqp = t3_pair
    placed = place(tqp, "cpu", torch.bfloat16)
    lin = placed["llama"]["layers"][1]["gate"]
    assert lin["w_q"].dtype == torch.int8 and lin["scale"].dtype == torch.float32
    assert placed["speech_head"]["w"].dtype == torch.bfloat16
    bad = jax.tree.map(lambda x: x, jqp)
    bad["llama"]["layers"][0]["q"] = dict(bad["llama"]["layers"][0]["q"],
                                          w_q=np.zeros((3, 3), np.int8))
    with pytest.raises(ValueError, match="w_q"):
        port_params(tt3.init, TINY, bad, "T3")
    bad["llama"]["layers"][0]["q"] = dict(jqp["llama"]["layers"][0]["q"], extra=np.zeros(2))
    with pytest.raises(ValueError, match="extra"):
        port_params(tt3.init, TINY, bad, "T3")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_matches_jax(rng, dtype):
    """The port's w_q branch against JAX L.linear on one quantised leaf:
    fp32 within 1e-6 relative; bf16 within one bf16 step of the JAX
    product (both round w_q * scale to bf16, then the product)."""
    w = rng.standard_normal((64, 48)).astype(np.float32) * rng.uniform(0.1, 2, 48)
    p = JL.quantize_linear({"w": w, "b": rng.standard_normal(48).astype(np.float32)})
    x = rng.standard_normal((5, 64)).astype(np.float32)
    tp = {k: t(v) for k, v in p.items()}
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                      torch.bfloat16)
    want = np.asarray(JL.linear(p, jnp.asarray(x), jd).astype(jnp.float32), np.float64)
    got = TL.linear(tp, t(x), td).float().numpy().astype(np.float64)
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    else:
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= step).all()


def test_int8_forward_logits_match_jax(rng, t3_pair):
    """t3.forward on JAX's int8 tree: the port within 1e-4 of JAX (fp32)."""
    _, jqp, _, tqp = t3_pair
    jc, tc = _cond(rng)
    text = np.concatenate([[5], rng.integers(1, 50, 8), [0]])[None].astype(np.int32)
    speech = rng.integers(0, 36, (1, 12)).astype(np.int32)
    _, want = jt3.forward(jqp, jc, jnp.asarray(text), jnp.asarray([10]), jnp.asarray(speech),
                          jnp.asarray([12]), TINY)
    _, got = tt3.forward(tqp, tc, t(text), t(np.array([10])), t(speech), t(np.array([12])),
                         TINY)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_int8_logits_close(rng, t3_pair):
    """tests/test_int8.py:test_int8_logits_close on the port's own trees."""
    _, _, tp, _ = t3_pair
    qp = tq.quantize_t3(tp)
    _, tc = _cond(rng)
    text = rng.integers(1, 50, (1, 10)).astype(np.int32)
    text[:, 0], text[:, -1] = 5, 0
    speech = rng.integers(0, 36, (1, 12)).astype(np.int32)
    args = (tc, t(text), t(np.array([10])), t(speech), t(np.array([12])), TINY)
    with torch.no_grad():
        _, fp = tt3.forward(tp, *args)
        _, q8 = tt3.forward(qp, *args)
    cos, rel = _cos_rel(fp, q8)
    assert cos > 0.995 and rel < 0.1, (cos, rel)


def test_int8_generation_well_formed(rng, t3_pair):
    _, _, tp, _ = t3_pair
    _, tc = _cond(rng)
    out = tt3.generate(tq.quantize_t3(tp), tc, np.array([[5, 3, 7, 9, 2, 0]], np.int32),
                       max_new_tokens=16, cfg_weight=0.5, seed=1, cfg=TINY, device="cpu")
    body = out[out != TINY.stop_speech_token]
    assert out.size > 0 and (body < 36).all() and (body >= 0).all()


def test_int8_teacher_forced_gate_metrics(rng, t3_pair):
    """tests/test_int8.py's promotion-gate metrics: top-1 agreement >= 0.9
    and median KL < 5e-3 over a teacher-forced stream."""
    _, _, tp, _ = t3_pair
    qp = tq.quantize_t3(tp)
    _, tc = _cond(rng)
    text = np.concatenate([[5], rng.integers(1, 50, 8), [0]])[None].astype(np.int32)
    toks = tt3.generate(tp, tc, text, max_new_tokens=64, temperature=0.7, cfg_weight=0.5,
                        seed=0, cfg=TINY, device="cpu")
    toks = toks[toks < TINY.start_speech_token]
    assert toks.size >= 8
    args = (tc, t(text), t(np.array([text.shape[1]])), t(toks[None].astype(np.int32)),
            t(np.array([toks.size])), TINY)
    with torch.no_grad():
        la = tt3.forward(tp, *args)[1][0, : toks.size].double().numpy()
        lb = tt3.forward(qp, *args)[1][0, : toks.size].double().numpy()
    assert (la.argmax(-1) == lb.argmax(-1)).mean() >= 0.9
    za = np.log(np.exp(la - la.max(-1, keepdims=True)).sum(-1)) + la.max(-1)
    zb = np.log(np.exp(lb - lb.max(-1, keepdims=True)).sum(-1)) + lb.max(-1)
    pa = np.exp(la - za[:, None])
    kl = (pa * (la - lb)).sum(-1) - za + zb
    assert np.median(kl) < 5e-3, np.median(kl)


def test_int8_s3gen_mel_close(rng, s3_pair):
    """tests/test_int8.py:test_int8_s3gen_mel_close on the port (cos > 0.99,
    rel < 0.15), and the port's int8 mel against the JAX package's int8
    mel within 1e-3."""
    jp, jqp, tp, tqp = s3_pair
    tokens = rng.integers(0, 6561, (2, 20)).astype(np.int32)
    token_len = np.array([8 + 20, 8 + 14], np.int32)
    pt = rng.integers(0, 6561, (2, 8)).astype(np.int32)
    pf = rng.standard_normal((2, 16, 8)).astype(np.float32)
    emb = rng.standard_normal((2, 192)).astype(np.float32)
    targs = (t(tokens).long(), t(token_len).long(), t(pt).long(), t(pf), t(emb))
    with torch.no_grad():
        mel_fp = ts3gen.flow_to_mel(tp, *targs, cfg=S3_TINY).double().numpy()
        mel_q8 = ts3gen.flow_to_mel(tq.quantize_s3gen(tp), *targs, cfg=S3_TINY)
    mel_q8 = mel_q8.double().numpy()
    cos, rel = _cos_rel(mel_fp, mel_q8)
    assert mel_fp.shape == mel_q8.shape and cos > 0.99 and rel < 0.15, (cos, rel)
    want = js3gen.flow_to_mel(jqp, jnp.asarray(tokens), jnp.asarray(token_len), jnp.asarray(pt),
                              jnp.asarray(pf), jnp.asarray(emb), finalize=True, cfg=S3_TINY)
    np.testing.assert_allclose(mel_q8, np.asarray(want, np.float64), atol=1e-3, rtol=0)


# ---------------------------------------------------------------------------
# 4: the int8 cache against the JAX package
# ---------------------------------------------------------------------------

def _slab_close(got, want, total: int, first: int = 0):
    """int8 slabs over slots [first, total): equal but for 1-steps at
    rounding boundaries on at most 0.1 % of the entries."""
    got = got[:, first:total].numpy().astype(np.int32)
    want = np.asarray(want)[:, first:total]
    diff = np.abs(got - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("defer", ["0", "1"])
def test_int8_cache_matches_jax(rng, t3_pair, monkeypatch, defer):
    """CHATTERBOX_INT8_KV=1, 4 utterances with ragged text: after
    start_generation the slabs and scales equal the JAX package's (slabs
    within one step at rounding boundaries, scales 1e-6 relative) and the
    logits within 1e-4; generate_batch gives equal tokens; also under the
    deferred insert (CHATTERBOX_DEFER_KV=1), whose current row each layer
    folds in unquantised. The slots compared are the context's [pad,
    p_len): the left pad's junk slots, which no step reads, hold the
    outputs of queries without a valid key, which the two packages define
    differently (ROADMAP, semantics that differ on purpose)."""
    jp, _, tp, _ = t3_pair
    jc, tc = _cond(rng)
    rows, lens = _ragged(rng, [6, 12, 9, 4])
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    monkeypatch.setenv("CHATTERBOX_DEFER_KV", defer)
    kw = dict(cfg_weight=0.5, max_new_tokens=24, text_lens=lens, cfg=TINY)
    js, jinfo = jt3.start_generation(jp, jc, rows, **kw)
    assert jt3.LAST_GENERATION_INFO["kv_int8"] is True
    ts, tinfo = tt3.start_generation(tp, tc, rows, device="cpu", **kw)
    assert tt3.LAST_GENERATION_INFO["kv_int8"] is True and tinfo["kv_int8"]
    c = ts.cache
    assert c.k.dtype == torch.int8 and c.k_scale.shape == c.k.shape[:-1]
    p_len, pad = tinfo["p_len"], tinfo["pad"]
    for got, want in ((c.k, js.cache.k), (c.v, js.cache.v)):
        _slab_close(got, want, p_len, pad)
    for got, want in ((c.k_scale, js.cache.k_scale), (c.v_scale, js.cache.v_scale)):
        np.testing.assert_allclose(got[:, pad:p_len].numpy(), np.asarray(want)[:, pad:p_len],
                                   rtol=1e-6, atol=0)
    np.testing.assert_allclose(ts.logits.numpy(), np.asarray(js.logits), atol=1e-4, rtol=0)
    gkw = dict(kw, seed=3, temperature=0.8)
    want = jt3.generate_batch(jp, jc, rows, **gkw)
    got = tt3.generate_batch(tp, tc, rows, make_draws=JaxDraws, device="cpu", **gkw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_int8_cache_prefill_close_to_the_float_cache(rng, t3_pair, monkeypatch):
    """tests/test_int8.py:test_int8_kv_cache_decode's bounds on the port:
    prefill logits of the int8 cache against the fp cache, cos > 0.995,
    rel < 0.1."""
    _, _, tp, _ = t3_pair
    _, tc = _cond(rng)
    rows = rng.integers(1, 50, (4, 10)).astype(np.int32)
    rows[:, 0], rows[:, -1] = 5, 0
    kw = dict(cfg_weight=0.4, max_new_tokens=12, cfg=TINY, device="cpu")
    s_fp, _ = tt3.start_generation(tp, tc, rows, **kw)
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    s_q, _ = tt3.start_generation(tp, tc, rows, **kw)
    cos, rel = _cos_rel(s_fp.logits, s_q.logits)
    assert cos > 0.995 and rel < 0.1, (cos, rel)


# ---------------------------------------------------------------------------
# 5: K1's int8 plain version against the JAX mode-1 decode
# ---------------------------------------------------------------------------

def _filled_cache(rng, b, lc):
    """A random int8 cache with scales, as numpy: (L, Lc, B, H, D) slabs and
    (L, Lc, B, H) scales from quantised normal rows."""
    lcfg = TINY.llama
    shape = (lcfg.num_layers, lc, b, lcfg.num_kv_heads, lcfg.head_dim)
    out = []
    for _ in range(2):
        x = rng.standard_normal(shape).astype(np.float32) * rng.uniform(0.2, 3, shape[:-1] + (1,))
        q, s = tllama.quantize_kv(torch.from_numpy(x.astype(np.float32)))
        out += [q.numpy(), s.numpy()]
    return out[0], out[2], out[1], out[3]


@pytest.mark.parametrize("case", ["plain", "holes", "spans", "defer"])
def test_int8_decode_step_matches_jax_mode_1(rng, t3_pair, monkeypatch, case):
    """One llama.forward decode step over the same int8 cache and scales on
    both sides: K1's plain version (K1s's with the deferred insert; K1 with
    per-row spans) against the JAX package's XLA mode-1 decode with the
    equal key mask: hidden states within 1e-5 (fp32), and the cache after
    the step's write."""
    jp, _, tp, _ = t3_pair
    b, lc, pos, start = 4, 40, 29, 3
    k, v, ks, vs = _filled_cache(rng, b, lc)
    x = rng.standard_normal((b, 1, TINY.hidden_size)).astype(np.float32)
    pos_ids = np.array([[pos - start]] * b, np.int64)
    kidx = np.arange(lc)
    lo, hi = np.full(b, start), np.full(b, pos)
    hole = np.zeros((b, 2), np.int32)
    span = None
    if case in ("holes", "defer"):
        hole = np.array([[8, 12], [0, 0], [5, 20], [28, 29]], np.int32)
    if case == "spans":
        lo, hi = np.array([0, 6, 2, 17]), np.array([pos, pos, 22, pos])
        hole = np.array([[10, 14], [0, 0], [30, 31], [20, 25]], np.int32)
        span = np.stack([lo, hi], 1).astype(np.int32)
    if case == "defer":
        monkeypatch.setenv("CHATTERBOX_DEFER_KV", "1")
    mask = ((kidx[None] >= lo[:, None]) & (kidx[None] <= hi[:, None])
            & ~((kidx[None] >= hole[:, :1]) & (kidx[None] < hole[:, 1:])))
    jcache = jllama.KVCache(*(jnp.asarray(a) for a in (k, v, ks, vs)))
    jh, jc = jllama.forward(jp["llama"], jnp.asarray(x), jnp.asarray(pos_ids.astype(np.int32)),
                            jnp.asarray(mask[:, None, :]), cache=jcache, cache_pos=pos,
                            cfg=TINY.llama)
    tcache = tllama.KVCache(*(torch.from_numpy(a.copy()) for a in (k, v, ks, vs)))
    th, tc = tllama.forward(tp["llama"], t(x), torch.from_numpy(pos_ids), cache=tcache,
                            cache_pos=pos, cfg=TINY.llama, flash_start=start,
                            flash_hole=torch.from_numpy(hole),
                            flash_span=None if span is None else torch.from_numpy(span))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    _slab_close(tc.k, jc.k, lc)
    _slab_close(tc.v, jc.v, lc)
    np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(jc.k_scale), rtol=1e-6, atol=0)


@pytest.mark.parametrize("deferred", [False, True])
def test_int8_walk_matches_the_plain_version(rng, deferred):
    """The int8 entry's schedule (walk_reference: tiles of INT8_TILE keys,
    scores x ks, probabilities x vs) against decode_attention_reference,
    fp32 within 1e-5; a stacked cache with a layer and holes."""
    b, h, d, lc, n_l = 4, 4, 64, 300, 2
    k, ks = tllama.quantize_kv(torch.randn(n_l, lc, b, h, d))
    v, vs = tllama.quantize_kv(torch.randn(n_l, lc, b, h, d) * 2)
    q = torch.randn(b, h, d)
    extra = dict(k_cur=torch.randn(b, h, d), v_cur=torch.randn(b, h, d)) if deferred else {}
    hole = torch.tensor([[10, 40], [0, 0], [100, 101], [0, 200]], dtype=torch.int32)
    args = (q, k, v, 250, 5, hole)
    kw = dict(layer=1, k_scale=ks, v_scale=vs, **extra)
    got = tfd.walk_reference(*args, **kw)
    want = tfd.decode_attention_reference(*args, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert tfd.LOADS[torch.int8] * tfd.SPLIT_WARPS * tfd.GROUPS == tfd.INT8_TILE


def _jax_mode_1(q, k, v, ks, vs, mask, k_cur=None, v_cur=None):
    """The JAX package's mode-1 read of an int8 cache
    (chatterbox_embed_tpu/models/llama.py:377-381, 418-440) in jnp: q (B,
    H, D) in the compute dtype, k, v (Lc, B, H, D) int8, ks, vs (Lc, B, H)
    fp32, mask (B, Lc); with k_cur / v_cur the current row is one more
    fp32 logit and value column."""
    dtype, d, lw = q.dtype, q.shape[-1], k.shape[0]
    logits = jnp.einsum("bhd,lbhd->bhl", q, k.astype(dtype),
                        preferred_element_type=jnp.float32)
    logits = logits * jnp.transpose(ks, (1, 2, 0)) / np.sqrt(d)
    logits = jnp.where(mask[:, None, :], logits, jnp.float32(-1e10))
    if k_cur is not None:
        lcur = jnp.sum(q.astype(jnp.float32) * k_cur.astype(jnp.float32), axis=-1) / np.sqrt(d)
        logits = jnp.concatenate([logits, lcur[..., None]], axis=-1)
    w = jax.nn.softmax(logits, axis=-1)
    wl = w[..., :lw] * jnp.transpose(vs, (1, 2, 0))
    att = jnp.einsum("bhl,lbhd->bhd", wl.astype(dtype), v.astype(dtype))
    if k_cur is not None:
        att = (att.astype(jnp.float32) + w[..., lw:] * v_cur.astype(jnp.float32)).astype(dtype)
    return att


def _close_rel(got, want, limit):
    """max |got - want| / max(1, |want|) <= limit (the card's bf16 int8 check)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert np.isfinite(got).all() and err.max() <= limit, err.max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["holes", "spans_wrap", "defer"])
def test_int8_walk_at_its_tile_matches_plain_and_jax_mode_1(case, dtype):
    """walk_reference on an int8 cache at the kernel's tile (INT8_TILE keys a
    tile, so at B*H = 256 and Lc 512 each of the 2 splits walks several
    tiles, the last partial) against decode_attention_reference and the JAX
    package's mode-1 read: per-row holes across tile and split edges;
    per-row spans, half of them wrapped to the cache's end (the engine's
    ring) with a hole inside; K1s's stacked cache with its current row
    folded in. fp32 within 1e-5; bf16 q within 2e-2 of max(1, |ref|), the
    card's int8 limits (the plain and JAX reads round w * vs to bf16)."""
    rng = np.random.default_rng({"holes": 1, "spans_wrap": 2, "defer": 3}[case])
    b, h, d, lc, start, pos = 16, 16, 64, 512, 4, 385
    n_l = 2 if case == "defer" else 1
    x = rng.standard_normal((2, n_l, lc, b, h, d)).astype(np.float32)
    x *= rng.uniform(0.3, 3.0, (2, n_l, lc, b, h, 1)).astype(np.float32)
    (k, ks), (v, vs) = (tllama.quantize_kv(torch.from_numpy(a)) for a in x)
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32)).to(dtype)
    lo, hi = np.full(b, start), np.full(b, pos - (case == "defer"))
    hole = np.stack([100 + 5 * np.arange(b), 140 + 9 * np.arange(b)], 1)   # across 132
    span, kw = None, {}
    if case == "spans_wrap":
        lo = rng.integers(0, 60, b)
        hi = np.where(np.arange(b) % 2 == 0, lc - 1, rng.integers(300, lc - 1, b))
        hole = np.stack([lo + 150, lo + 150 + rng.integers(0, 120, b)], 1)
        span = torch.tensor(np.stack([lo, hi], 1), dtype=torch.int32)
    if case == "defer":
        kw = dict(layer=1, k_cur=torch.randn(b, h, d).to(dtype), v_cur=torch.randn(b, h, d).to(dtype))
    if case != "defer":
        k, v, ks, vs = k[0], v[0], ks[0], vs[0]
    args = (q, k, v, pos, start, torch.tensor(hole, dtype=torch.int32))
    kw.update(span=span, k_scale=ks, v_scale=vs)
    walk = tfd.walk_reference(*args, **kw)
    plain = tfd.decode_attention_reference(*args, **kw)
    idx = np.arange(lc)[None]
    mask = ((idx >= lo[:, None]) & (idx <= hi[:, None])
            & ~((idx >= hole[:, :1]) & (idx < hole[:, 1:])))
    layer = kw.get("layer", 0)
    kl, vl = (a[layer] if a.dim() == 5 else a for a in (k, v))
    ksl, vsl = (a[layer] if a.dim() == 4 else a for a in (ks, vs))
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    cur = {}
    if case == "defer":
        cur = {n: jnp.asarray(kw[n].float().numpy()).astype(jd) for n in ("k_cur", "v_cur")}
    jax_out = _jax_mode_1(jnp.asarray(q.float().numpy()).astype(jd), jnp.asarray(kl.numpy()),
                          jnp.asarray(vl.numpy()), jnp.asarray(ksl.numpy()),
                          jnp.asarray(vsl.numpy()), jnp.asarray(mask), **cur)
    jax_out = np.asarray(jax_out.astype(jnp.float32))
    assert walk.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(walk.numpy(), plain.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(walk.numpy(), jax_out, atol=1e-5, rtol=0)
    else:
        _close_rel(walk.float().numpy(), plain.float().numpy(), 2e-2)
        _close_rel(walk.float().numpy(), jax_out, 2e-2)


def test_byte_permute_conversion_is_exact():
    """The int8 walk's int8 -> fp32 conversion (csrc/flash_decode.cu:
    unpack_int8): __byte_perm(w ^ 0x80808080, kI8Magic, 0x7540 | i) read as
    fp32 minus kI8Offset, emulated in numpy for every byte value at every
    byte position of a word, equals int8 -> float32 bit for bit."""
    import re
    from chatterbox_embed_tpu_torch.kernels import _build
    text = (_build.CSRC / "flash_decode.cu").read_text()
    magic = int(re.search(r"constexpr unsigned kI8Magic = (0x[0-9A-Fa-f]+)u;", text).group(1), 16)
    offset = np.float32(re.search(r"constexpr float kI8Offset = ([\d.]+)f;", text).group(1))
    assert "const unsigned a = r.x ^ 0x80808080u, b = r.y ^ 0x80808080u;" in text
    assert "__uint_as_float(__byte_perm(a, kI8Magic, 0x7540 | i)) - kI8Offset" in text
    raw = np.arange(256, dtype=np.uint32)
    words = raw | np.roll(raw, 1) << 8 | np.roll(raw, 2) << 16 | np.roll(raw, 3) << 24
    flipped = words ^ np.uint32(0x80808080)
    # __byte_perm(x, y, s): result byte n is byte s[4n + 2 : 4n] of (y:x)
    pool = [(flipped >> 8 * n) & 0xFF for n in range(4)] + \
        [np.full_like(words, (magic >> 8 * n) & 0xFF) for n in range(4)]
    for i in range(4):
        sel = 0x7540 | i
        bits = sum(pool[(sel >> 4 * n) & 0x7] << 8 * n for n in range(4)).astype(np.uint32)
        got = bits.view(np.float32) - offset
        want = ((words >> 8 * i) & 0xFF).astype(np.uint8).view(np.int8).astype(np.float32)
        assert sorted(want.tolist()) == list(range(-128, 128))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_int8_cache_without_scales_is_refused():
    k, _ = tllama.quantize_kv(torch.randn(20, 2, 4, 64))
    q = torch.randn(2, 4, 64)
    with pytest.raises(ValueError, match="int8 cache needs"):
        tfd.decode_attention(q, k, k, 10)
    with pytest.raises(ValueError, match="int8 cache needs"):
        tfd.decode_attention(q, q[None].expand(20, -1, -1, -1).contiguous(),
                             q[None].expand(20, -1, -1, -1).contiguous(), 10,
                             k_scale=torch.ones(20, 2, 4), v_scale=torch.ones(20, 2, 4))


# ---------------------------------------------------------------------------
# 6: the engine and the fence
# ---------------------------------------------------------------------------

def test_engine_int8_kv_isolation(rng, t3_pair):
    """tests/test_continuous.py:test_engine_int8_kv_isolation on the port:
    under traffic (3 requests through 2 slots, int8 cache) each request's
    tokens equal the JAX engine's and the request's own run alone."""
    jp, _, tp, _ = t3_pair
    jc, tc = _cond(rng)
    texts = [np.concatenate([[5], rng.integers(1, 50, n), [0]])[None].astype(np.int32)
             for n in (6, 9, 4)]
    geo = dict(slots=2, text_bucket=16, max_new_tokens=12, block=4)
    jeng_ = jeng.ContinuousDecoder(jp, TINY, kv_int8=True, **geo)
    teng_ = teng.ContinuousDecoder(tp, TINY, kv_int8=True, make_draws=JaxDraws, device="cpu",
                                   **geo)
    assert teng_.state.cache.k.dtype == torch.int8 and teng_.state.cache.k_scale is not None
    for i, tx in enumerate(texts):
        jeng_.submit(tx, jc, seed=20 + i)
        teng_.submit(tx, tc, seed=20 + i)
    jout, tout = jeng_.drain(), teng_.drain()
    for rid in range(len(texts)):
        np.testing.assert_array_equal(tout[rid], np.asarray(jout[rid]))
        alone = teng.ContinuousDecoder(tp, TINY, kv_int8=True, make_draws=JaxDraws,
                                       device="cpu", **geo)
        alone.submit(texts[rid], tc, seed=20 + rid)
        np.testing.assert_array_equal(alone.drain()[0], tout[rid])


def test_engine_kv_int8_follows_the_setting(t3_pair, monkeypatch):
    _, _, tp, _ = t3_pair
    geo = dict(slots=1, text_bucket=16, max_new_tokens=8, device="cpu")
    assert teng.ContinuousDecoder(tp, TINY, **geo).state.cache.k_scale is None
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    assert teng.ContinuousDecoder(tp, TINY, **geo).state.cache.k.dtype == torch.int8
    assert teng.ContinuousDecoder(tp, TINY, kv_int8=False, **geo).state.cache.k_scale is None


def test_slot_derivation_honors_explicit_kv_int8(monkeypatch):
    """tests/test_continuous.py's test on the port: an explicit kv_int8
    sizes the default slots against the cache the engine allocates, not
    the ambient setting (a fence of 8 int8 CFG slots holds 4 of fp32)."""
    from chatterbox_embed_tpu_torch.serving import continuous
    from torch_parity import tiny_pipeline_config
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    cfg = tiny_pipeline_config()
    tts = ChatterboxTTS.from_random(seed=0, config=cfg, device="cpu")
    bucket, cap_new = 32, 16
    _, capacity = teng.engine_geometry(cfg.t3, bucket, 2 + cfg.t3.perceiver_num_queries, cap_new)
    per_int8 = tt3.kv_bytes_per_token_row(cfg.t3, kv_int8=True)
    free = int(8 * 2 * capacity * per_int8 / tt3.KV_FENCE_FRACTION)
    monkeypatch.setattr(tt3, "free_device_bytes", lambda device: free)
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    kw = dict(text_bucket=bucket, max_new_tokens=cap_new, block=8)
    assert continuous.ContinuousServer(tts, kv_int8=True, **kw).decoder.slots == 8
    # fp32 at D = 16: 4 bytes x 16 against int8's 16 + 4 bytes, 3.2x: 2 slots
    assert continuous.ContinuousServer(tts, kv_int8=False, **kw).decoder.slots == 2


def test_fence_counts_the_scale_planes(monkeypatch):
    """The int8 cache's bytes a token-row are L * 2 * H * (D + 4): its fp32
    scale planes counted (the JAX package's fence leaves them out, ROADMAP
    reference fault 3); the int8 base cap doubles to 32."""
    from chatterbox_embed_tpu_torch.config import T3Config
    full = T3Config()
    assert tt3.kv_bytes_per_token_row(full, kv_int8=True) == 30 * 2 * 16 * (64 + 4)
    assert tt3.kv_bytes_per_token_row(full, torch.bfloat16) == 30 * 2 * 16 * 64 * 2
    assert tt3.max_decode_utterances(kv_int8=True) == 32
    assert tt3.max_decode_utterances(kv_int8=False) == 16
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    assert tt3.max_decode_utterances() == 32
    # room for 66 CFG rows of slabs alone: 33 utterances, snapped to 32, as
    # the JAX package's count gives; with the scales (6 % more) 62 rows, 31
    # utterances, snapped to 16
    cap = 1280
    slabs_only = 30 * 2 * 16 * 64
    free = int(66 * cap * slabs_only / tt3.KV_FENCE_FRACTION)
    assert tt3.max_decode_utterances(cap, cfg=full, free_bytes=free, kv_int8=True) == 16
    free_fit = int(66 * cap * tt3.kv_bytes_per_token_row(full, kv_int8=True)
                   / tt3.KV_FENCE_FRACTION)
    assert tt3.max_decode_utterances(cap, cfg=full, free_bytes=free_fit, kv_int8=True) == 32


def test_start_generation_fences_the_cache_it_allocates(rng, t3_pair, monkeypatch):
    """The fence reads the cache start_generation will allocate: 17
    utterances pass with the int8 cache's doubled cap and fail without."""
    _, _, tp, _ = t3_pair
    _, tc = _cond(rng)
    rows = np.tile(np.array([[5, 3, 7, 0]], np.int32), (tt3.MAX_DECODE_UTTERANCES + 1, 1))
    kw = dict(cfg_weight=0.5, max_new_tokens=8, cfg=TINY, device="cpu")
    with pytest.raises(ValueError, match="max_decode_utterances"):
        tt3.start_generation(tp, tc, rows, **kw)
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    s, info = tt3.start_generation(tp, tc, rows, **kw)
    assert info["kv_int8"] and s.done.shape[0] == tt3.MAX_DECODE_UTTERANCES + 1


def test_int8_backbone_never_takes_the_fused_step(rng, t3_pair, monkeypatch):
    """K4 streams a bf16 wall: an int8 backbone decodes through K1 under
    CHATTERBOX_FUSED_STEP=1, and the int8 cache yields to K4 where K4
    serves (a bf16 backbone)."""
    _, _, tp, tqp = t3_pair
    _, tc = _cond(rng)
    monkeypatch.setenv("CHATTERBOX_FUSED_STEP", "1")
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    kw = dict(cfg_weight=0.5, max_new_tokens=8, cfg=TINY, device="cpu")
    text = np.array([[5, 3, 7, 0]], np.int32)
    _, info = tt3.start_generation(tqp, tc, text, **kw)
    assert not info["use_fused"] and info["kv_int8"]
    if tt3.fused_decode.plan(TINY.llama, 2) is not None:
        _, info = tt3.start_generation(tp, tc, text, **kw)
        assert info["use_fused"] and not info["kv_int8"]
    assert not tt3.fused_weights(tqp) and tt3.fused_weights(tp)


def test_int8_weights_cannot_be_placed_on_a_mesh(t3_pair):
    """The T3 spec names only a linear's "w" (the JAX _llama_spec): an int8
    backbone is refused before any broadcast, naming the w_q leaf."""
    from chatterbox_embed_tpu_torch.parallel import mesh as tmesh
    _, _, _, tqp = t3_pair
    with pytest.raises(ValueError, match=r"llama/layers/0/q/w_q.*int8 weights"):
        tmesh.shard_params(tqp, tmesh.t3_param_spec(tqp), mesh=None)


# ---------------------------------------------------------------------------
# 7: the phased geometry
# ---------------------------------------------------------------------------

def test_phased_run_equals_the_jax_packages(rng, t3_pair, monkeypatch):
    """Under CHATTERBOX_PHASED_CACHE=3 the JAX package decodes in phases
    (its XLA path reads prefixes); the port decodes in one and gives the
    phased run's tokens."""
    jp, _, tp, _ = t3_pair
    jc, tc = _cond(rng)
    rows, lens = _ragged(rng, [6, 12, 9, 4])
    monkeypatch.setenv("CHATTERBOX_PHASED_CACHE", "3")
    kw = dict(max_new_tokens=40, cfg_weight=0.5, seed=6, text_lens=lens, cfg=TINY)
    want = jt3.generate_batch(jp, jc, rows, **kw)
    assert len(jt3.LAST_GENERATION_INFO["phase_totals"]) >= 2
    got = tt3.generate_batch(tp, tc, rows, make_draws=JaxDraws, device="cpu", **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
