"""The port's continuous engine (models/t3_engine.py) against the JAX
package's, and K1's per-row span (kernels/flash_decode.py) that its step
attends through.

- engine_spans: the span and hole each row gets equal the JAX engine's
  written-at-step (ws) mask key for key, over hypothesis-drawn engine
  histories (ring size, pads, join steps, live or finished, wrapped or not,
  the full ring).
- K1's plain version and walk_reference with spans equal a masked softmax
  written out here (fp32, 1e-5); a row with an empty span gives 0.
- The engine, the properties of tests/test_continuous.py against the JAX
  engine, the port drawing JAX's per-request draws (`JaxDraws(seed)`:
  fold_in(PRNGKey(seed), i) at the request's step i): equal tokens per
  request under traffic (3 requests through 2 slots), after the ring wraps
  (5 through 1 slot, R = 6), at limits and EOS, and equal blocks_run,
  steps_run and g; near-greedy tokens equal to the port's own t3.generate;
  the refusals of submit; an idle step clears last_block_tokens (the JAX
  package's keeps the previous block's, ROADMAP §3)."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from hypothesis import example, given, settings, strategies as st

from chatterbox_embed_tpu.models import t3 as jt3
from chatterbox_embed_tpu.models import t3_engine as jeng
from chatterbox_embed_tpu_torch.kernels import flash_decode as tfd
from chatterbox_embed_tpu_torch.models import t3 as tt3
from chatterbox_embed_tpu_torch.models import llama as tllama
from chatterbox_embed_tpu_torch.models import t3_engine as teng
from chatterbox_embed_tpu_torch.utils import profiling
from test_torch_t3 import TINY
from torch_parity import JaxDraws, port_params, t

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    jp = jt3.init(jax.random.PRNGKey(0), TINY)
    return jp, port_params(tt3.init, TINY, jp, "T3")


def _cond(rng):
    spk = rng.standard_normal((1, 16)).astype(np.float32)
    prompt = rng.integers(0, 36, (1, 6)).astype(np.int32)
    return (jt3.T3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5),
            tt3.T3Cond(t(spk), t(prompt), 0.5))


def _text(rng, n=6):
    return np.concatenate([[5], rng.integers(1, 50, n), [0]])[None].astype(np.int32)


def _engines(models, kv_int8=False, **kw):
    jp, tp = models
    return (jeng.ContinuousDecoder(jp, TINY, kv_int8=kv_int8, **kw),
            teng.ContinuousDecoder(tp, TINY, make_draws=JaxDraws, device="cpu", kv_int8=kv_int8,
                                   **kw))


def _run_both(models, reqs, **kw):
    """reqs: (text, (jax cond, port cond), submit kwargs). Returns each
    engine's tokens per request, and the engines."""
    je, te = _engines(models, **kw)
    jr = [je.submit(tx, c[0], **sk) for tx, c, sk in reqs]
    tr = [te.submit(tx, c[1], **sk) for tx, c, sk in reqs]
    jo, to = je.drain(), te.drain()
    return [np.asarray(jo[r]) for r in jr], [to[r] for r in tr], je, te


def _assert_same_run(jtoks, ttoks, je, te):
    for a, b in zip(jtoks, ttoks, strict=True):
        np.testing.assert_array_equal(b, a)
    assert (te.blocks_run, te.steps_run, te.state.g) == (je.blocks_run, je.steps_run,
                                                        int(je.state.g))


# -- K1's span --------------------------------------------------------------

def _jax_ws_mask(pad, gs, g, p_len, ring):
    """The JAX engine's mask (t3_engine.py:311-321) for one live row at
    global step g, with ws rebuilt from the ring's write history."""
    ws = np.full((ring,), -1)
    for step in range(g + 1):
        ws[step % ring] = step
    k = np.arange(p_len + ring)
    wsx = np.concatenate([np.full((p_len,), -1), ws])
    i = g - gs
    return ((k >= pad) & (k < p_len)) | ((wsx >= gs) & (wsx - gs <= i))


def _span_mask(span, hole, total):
    k = np.arange(total)[None]
    return ((k >= span[:, :1]) & (k <= span[:, 1:]) & ~((k >= hole[:, :1]) & (k < hole[:, 1:])))


@settings(max_examples=80, deadline=None)
@given(ring=st.integers(1, 12), p_len=st.integers(1, 9), g=st.integers(0, 40),
       data=st.data())
@example(ring=6, p_len=4, g=17, data=None)      # full ring, wrapped, (a = c + 1)
def test_spans_equal_the_jax_ws_mask(ring, p_len, g, data):
    n = 3
    if data is None:
        pads, back, dead = [0, 3, 1], [ring - 1, 0, 2], [False, False, True]
    else:
        pads = data.draw(st.lists(st.integers(0, p_len - 1), min_size=n, max_size=n))
        back = data.draw(st.lists(st.integers(0, min(g, ring - 1)), min_size=n, max_size=n))
        dead = data.draw(st.lists(st.booleans(), min_size=n, max_size=n))
    gs = [g - b for b in back]                  # a live slot joined at most R - 1 steps ago
    span, hole = teng.engine_spans(torch.tensor(pads), torch.tensor(gs), torch.tensor(dead),
                                   g, p_len, ring)
    assert span.dtype == hole.dtype == torch.int32 and span.shape == (2 * n, 2)
    got = _span_mask(span.numpy(), hole.numpy(), p_len + ring)
    for s in range(n):
        for row in (s, n + s):                  # the slot's cond and uncond rows
            if dead[s]:
                assert span[row, 0] > span[row, 1]
                assert not got[row].any()
            else:
                np.testing.assert_array_equal(got[row], _jax_ws_mask(pads[s], gs[s], g, p_len,
                                                                     ring))


def _masked_softmax(q, k, v, mask):
    """Attention written out in numpy: (B, H, D) over (Lc, B, H, D) keys,
    True = attend; a row with no key gives 0."""
    logits = np.einsum("bhd,kbhd->bhk", q, k) / np.sqrt(q.shape[-1])
    logits = np.where(mask[:, None, :], logits, -np.inf)
    mx = np.max(logits, axis=-1, keepdims=True)
    w = np.exp(logits - np.where(np.isfinite(mx), mx, 0.0))
    den = w.sum(-1, keepdims=True)
    w = np.where(den > 0, w / np.where(den > 0, den, 1.0), 0.0)
    return np.einsum("bhk,kbhd->bhd", w, v)


@pytest.mark.parametrize("b,h,lc", [(4, 2, 40), (8, 4, 420), (2, 16, 1292)])
def test_span_reference_and_walk_equal_a_masked_softmax(rng, b, h, lc):
    """Spans as the engine gives them (wrapped, unwrapped, the full ring,
    an empty hole, an empty span) plus arbitrary ones past the cache's
    ends, which the kernel clamps."""
    q = rng.standard_normal((b, h, 64)).astype(np.float32)
    k, v = (rng.standard_normal((lc, b, h, 64)).astype(np.float32) for _ in range(2))
    p_len = lc // 3
    span = np.zeros((b, 2), np.int32)
    hole = np.zeros((b, 2), np.int32)
    for r in range(b):
        kind = r % 4
        if kind == 0:        # no wrap
            span[r] = [r % p_len, p_len + 5 + r]
            hole[r] = [p_len, p_len + 3]
        elif kind == 1:      # wrap, hole inside the ring
            span[r] = [1, lc - 1]
            hole[r] = [p_len + 2 + r, p_len + 9 + r]
        elif kind == 2:      # empty span (a dead row)
            span[r] = [1, 0]
            hole[r] = [p_len, p_len + 1]
        else:                # a span past both ends of the cache
            span[r] = [-7, lc + 20]
            hole[r] = [p_len + 4, p_len + 4]
    mask = _span_mask(np.clip(span, 0, lc - 1), hole, lc)
    want = _masked_softmax(q, k, v, mask)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), lc - 1, 0,
            torch.from_numpy(hole))
    ts = torch.from_numpy(span)
    plain = tfd.decode_attention_reference(*args, span=ts)
    walk = tfd.walk_reference(*args, span=ts)
    via_wrapper = tfd.decode_attention(*args, span=ts)     # CPU: the plain version
    for got in (plain, walk, via_wrapper):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert not plain[2::4].any()


def test_span_is_k1s_free_and_checked_on_the_card():
    q = torch.zeros((2, 2, 64))
    k = torch.zeros((3, 8, 2, 2, 64))
    with pytest.raises(ValueError, match="span"):
        tfd.decode_attention(q, k, k, 4, layer=0, k_cur=q, v_cur=q,
                             span=torch.zeros((2, 2), dtype=torch.int32))


# -- the engine against the JAX engine --------------------------------------

def test_engine_isolation_under_traffic(models, rng):
    """3 requests through 2 slots (a refill mid-decode): the JAX engine's
    tokens request for request, and each request alone gives the same."""
    conds = [_cond(rng) for _ in range(3)]
    texts = [_text(rng, n) for n in (4, 6, 8)]
    kws = [dict(seed=s, temperature=tp) for s, tp in ((7, 0.8), (8, 1.2), (9, 0.6))]
    geo = dict(slots=2, text_bucket=16, max_new_tokens=16, block=4)
    jtoks, ttoks, je, te = _run_both(models, list(zip(texts, conds, kws)), **geo)
    _assert_same_run(jtoks, ttoks, je, te)
    assert te.blocks_run > 1
    for tx, c, kw, busy in zip(texts, conds, kws, ttoks):
        solo = teng.ContinuousDecoder(models[1], TINY, make_draws=JaxDraws, device="cpu",
                                      **dict(geo, slots=1))
        rid = solo.submit(tx, c[1], **kw)
        np.testing.assert_array_equal(solo.drain()[rid], busy)


def test_engine_ring_wraparound(models, rng):
    """5 requests through 1 slot with a 6-column ring: the ring wraps more
    than twice, and later occupants still decode the JAX engine's tokens."""
    reqs = [(_text(rng, 4), _cond(rng), dict(seed=40 + i, max_new_tokens=6)) for i in range(5)]
    jtoks, ttoks, je, te = _run_both(models, reqs, slots=1, text_bucket=16,
                                     max_new_tokens=6, block=3)
    _assert_same_run(jtoks, ttoks, je, te)
    assert te.state.g > 12


@pytest.mark.parametrize("limit", [1, 3, 16])
def test_engine_limit_and_eos_trim(models, rng, limit):
    """A request capped by max_new_tokens returns at most `limit` ids and
    no fill-EOS; an EOS-terminated one ends with EOS; both as the JAX
    engine (two slots, two requests with different limits)."""
    reqs = [(_text(rng), _cond(rng), dict(seed=5, max_new_tokens=limit)),
            (_text(rng, 3), _cond(rng), dict(seed=6, temperature=1.5))]
    jtoks, ttoks, je, te = _run_both(models, reqs, slots=2, text_bucket=16,
                                     max_new_tokens=16, block=8)
    _assert_same_run(jtoks, ttoks, je, te)
    out = ttoks[0]
    eos = TINY.stop_speech_token
    assert out.shape[0] <= limit
    if eos in out:
        assert out[-1] == eos and np.count_nonzero(out == eos) == 1


def test_engine_near_greedy_matches_generate(models, rng):
    """At temperature 1e-4 the draw scheme no longer matters: the engine's
    per-row masks, positions and ring inserts reproduce the port's
    lock-step t3.generate token for token (with its own default draws)."""
    cond = _cond(rng)[1]
    text = _text(rng)
    ref = tt3.generate(models[1], cond, text, max_new_tokens=16, temperature=1e-4,
                       cfg_weight=0.5, seed=3, cfg=TINY, device="cpu")
    eng = teng.ContinuousDecoder(models[1], TINY, slots=2, text_bucket=16, max_new_tokens=16,
                                 block=8, device="cpu")
    rid = eng.submit(text, cond, seed=11, temperature=1e-4)
    np.testing.assert_array_equal(eng.drain()[rid], ref)


def test_engine_refusals(models, rng, monkeypatch):
    eng = teng.ContinuousDecoder(models[1], TINY, slots=1, text_bucket=8, max_new_tokens=8,
                                 block=4, device="cpu")
    with pytest.raises(ValueError, match="text bucket"):
        eng.submit(_text(rng, 12), _cond(rng)[1])
    with pytest.raises(ValueError, match="cond width"):
        eng.submit(_text(rng, 3), tt3.T3Cond(speaker_emb=torch.zeros((1, 16))))
    with pytest.raises(ValueError, match="use_top_p"):
        eng.submit(_text(rng, 3), _cond(rng)[1], top_p=0.9)
    assert eng.idle
    # kv_int8=True builds the int8 cache (ROADMAP item 22); the int8
    # x int8 mode (not ported yet) is still refused
    geo = dict(slots=1, text_bucket=8, max_new_tokens=8, device="cpu")
    assert teng.ContinuousDecoder(models[1], TINY, kv_int8=True, **geo).state.cache.k.dtype \
        == torch.int8
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "2")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        teng.ContinuousDecoder(models[1], TINY, **geo)


def test_idle_step_clears_last_block_tokens(models, rng):
    """After the last request finishes, an idle step() returns {} and
    leaves no block tokens behind (a streaming consumer would otherwise
    read the finished request's last block again)."""
    eng = teng.ContinuousDecoder(models[1], TINY, slots=1, text_bucket=16, max_new_tokens=4,
                                 block=8, device="cpu")
    rid = eng.submit(_text(rng), _cond(rng)[1], seed=2)
    done = eng.step()
    assert rid in done and rid in eng.last_block_tokens and eng.idle
    assert eng.step() == {}
    assert eng.last_block_tokens == {}
    assert eng.blocks_run == 1


def test_engine_draws_per_request(models, rng):
    """The default draws come from each request's own seed: the same
    request gives the same tokens alone and beside another, and a request
    with another seed may differ."""
    c, tx = _cond(rng)[1], _text(rng)
    geo = dict(text_bucket=16, max_new_tokens=12, block=4, device="cpu")

    def run(extra):
        eng = teng.ContinuousDecoder(models[1], TINY, slots=2, **geo)
        rid = eng.submit(tx, c, seed=21, temperature=1.0)
        if extra:
            eng.submit(_text(rng, 3), c, seed=99, temperature=1.3)
        return eng.drain()[rid]

    np.testing.assert_array_equal(run(False), run(True))


# -- the step in pieces (the card's CUDA graphs, called eagerly here) --------

def _k1_counter(calls):
    """A stand-in for llama.decode_attention with the benchmark's record
    signature: counts the calls that reach the module attribute."""
    k1 = tllama.decode_attention

    def counted(q, k, v, cache_pos, start=0, hole=None, layer=None, k_cur=None, v_cur=None,
                span=None, k_scale=None, v_scale=None):
        assert isinstance(cache_pos, int) and torch.is_tensor(span) and torch.is_tensor(hole)
        calls.append(span)                  # kept, as the benchmark keeps it
        return k1(q, k, v, cache_pos, start=start, hole=hole, span=span, k_scale=k_scale,
                  v_scale=v_scale)
    return counted


def _refuse(*args, **kwargs):
    raise AssertionError("the eager step ran")


@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", ["ring_wraps", "ends_on_done"])
def test_pieced_step_matches_the_jax_engine(models, rng, monkeypatch, case, kv_int8):
    """The step's pieces, called eagerly, decode the JAX engine's tokens
    with the compute-dtype and the int8 cache: 4 requests through 1 slot
    with a 6-column ring (it wraps twice), and 3 through 2 slots whose
    last block ends early on done.all(). K1 runs between the pieces, once
    a layer a step, through the module attribute llama.decode_attention
    with a span and hole made that step."""
    if case == "ring_wraps":
        reqs = [(_text(rng, 4), _cond(rng), dict(seed=40 + i, max_new_tokens=6))
                for i in range(4)]
        geo = dict(slots=1, text_bucket=16, max_new_tokens=6, block=3)
    else:
        reqs = [(_text(rng, n), _cond(rng), dict(seed=50 + n, max_new_tokens=lim))
                for n, lim in ((4, 5), (6, 11), (5, 3))]
        geo = dict(slots=2, text_bucket=16, max_new_tokens=12, block=8)
    calls = []
    monkeypatch.setattr(tllama, "decode_attention", _k1_counter(calls))
    monkeypatch.setattr(teng, "engine_decode_block", _refuse)
    jtoks, ttoks, je, te = _run_both(models, reqs, kv_int8=kv_int8, **geo)
    _assert_same_run(jtoks, ttoks, je, te)
    assert (te.state.cache.k.dtype == torch.int8) == kv_int8
    assert len(calls) == TINY.llama.num_layers * te.steps_run
    assert len({id(x) for x in calls}) == te.steps_run      # a fresh span each step
    if case == "ring_wraps":
        assert te.state.g > 2 * geo["max_new_tokens"]
    else:
        assert te.steps_run < te.blocks_run * geo["block"]


class _Recorded:
    """A draw factory that logs every gumbel call as (seed, step) and
    draws JAX's noise."""

    def __init__(self, log):
        self.log = log

    def __call__(self, seed):
        rec = JaxDraws(seed)
        gumbel = rec.gumbel

        def logged(step, shape):
            self.log.append((seed, step))
            return gumbel(step, shape)
        rec.gumbel = logged
        return rec


def test_read_ahead_draws_follow_the_eager_loop(models, rng):
    """The pieced block draws step n+1's rows before it reads step n's
    done.all(): across block ends, a refill and the all-done stop that ends
    the run, every source is called for the same steps in the same order
    as the eager loop calls it, and the tokens are the same. The only
    calls more are at the all-done stop: one a request it held, at the
    step after that request's last, all of them finished."""
    conds = [_cond(rng)[1] for _ in range(3)]
    texts = [_text(rng, n) for n in (4, 7, 5)]
    limits = [6, 9, 5]
    geo = dict(slots=2, text_bucket=16, max_new_tokens=12, block=4, device="cpu")
    logs, toks = {}, {}
    for pieced in (False, True):
        log = logs[pieced] = []
        eng = teng.ContinuousDecoder(models[1], TINY, make_draws=_Recorded(log), **geo)
        assert eng.pieces is not None
        if not pieced:
            eng.pieces = None               # the step whole, as a mesh takes it
        rids = [eng.submit(tx, c, seed=70 + i, max_new_tokens=lim)
                for i, (tx, c, lim) in enumerate(zip(texts, conds, limits))]
        out = eng.drain()
        toks[pieced] = [out[r] for r in rids]
        assert eng.blocks_run > 2
    for a, b in zip(toks[False], toks[True], strict=True):
        np.testing.assert_array_equal(b, a)
    last = {}
    for seed, step in logs[False]:
        last[seed] = max(step, last.get(seed, -1))
    extra = [(seed, step) for seed, step in logs[True] if step > last[seed]]
    assert extra and all(step == last[seed] + 1 for seed, step in extra)
    assert len({seed for seed, _ in extra}) == len(extra)
    assert [x for x in logs[True] if x not in extra] == logs[False]


def test_the_cpu_engine_takes_the_eager_step(models, rng, monkeypatch):
    """Off the card the engine calls the step's pieces as they are, never
    the whole step: nothing is captured, and the counter of graphed steps
    stays at 0 while every step is counted."""
    monkeypatch.setattr(teng, "engine_decode_block", _refuse)
    eng = teng.ContinuousDecoder(models[1], TINY, slots=2, text_bucket=16, max_new_tokens=8,
                                 block=4, device="cpu")
    assert eng.pieces is not None and not eng.pieces.graphs.on_card
    profiling.reset()
    profiling.enable()
    try:
        for i in range(3):
            eng.submit(_text(rng, 3 + i), _cond(rng)[1], seed=i)
        eng.drain()
        got = profiling.totals()
    finally:
        profiling.disable()
        profiling.reset()
    assert got["counters"].get("engine.graphed_steps", 0) == 0
    assert not eng.pieces.graphs.captured and "engine.capture" not in got["spans"]
    assert got["spans"]["engine.forward"]["calls"] == eng.steps_run > 0
