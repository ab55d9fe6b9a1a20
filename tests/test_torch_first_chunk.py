"""The stream's first-chunk program of the port (streaming.first_chunk,
continue_tokens, WindowedSynth.seed_from_fused and the fused route of
ChatterboxTTS.stream_generate) against the JAX package's at a tiny config,
fp32, with JAX's own draws fed to the port (tests/torch_parity.py:
JaxDraws). On the CPU the port runs the program's static-shape body
eagerly; on the card the same body is one CUDA graph per text bucket
(chip_smoke.py's first_chunk phase holds the graph to the per-block route).

Tolerances:
- tokens, n_new, n_valid_mel, the state's step and done flags: equal;
- mu_tail, mel_tail: 1e-4 (ten Euler steps of the estimator, fp32
  summation order only: test_torch_streaming.py's flow-window bound);
- phase_carry: 1e-4 (test_torch_streaming.py's vocoder-window bound);
- the first wav and the streamed chunks against the JAX package: 1e-3, the
  one-shot wav's bound (test_torch_tts.py: the HiFT head's exp() amplifies
  fp32 drift);
- within the port, the fused route against the per-block route: rtol 1e-4,
  atol 1e-5 (the JAX package's test_stream_fused_equals_unfused).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from chatterbox_embed_tpu import streaming as jstreaming
from chatterbox_embed_tpu_torch import streaming as tstreaming
from chatterbox_embed_tpu_torch.kernels import flash_decode as tfd
from chatterbox_embed_tpu_torch.kernels import fused_decode as tfu
from chatterbox_embed_tpu_torch.models import hifigan as thift
from chatterbox_embed_tpu_torch.models import s3gen as ts3
from chatterbox_embed_tpu_torch.models import t3 as tt3
from chatterbox_embed_tpu_torch.ops.sampling import Draws
from torch_dist import tiny_conds, tiny_pipeline_config as tiny_port_config
from torch_parity import JaxDraws, tiny_pipeline_config, tiny_tts_pair

torch.set_num_threads(2)
TINY = tiny_pipeline_config()
TEXTS = ("Hello there.", "A somewhat longer sentence here.")    # 14 and 34 tokens: bucket 48
SAMPLE = dict(temperature=0.7, cfg_weight=0.5, repetition_penalty=1.2, min_p=0.05, top_p=1.0)
TIGHT = dict(atol=1e-4, rtol=1e-4)
WAV = dict(atol=1e-3)
ROUTES = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    mp = pytest.MonkeyPatch()
    yield tiny_tts_pair(TINY, mp)
    mp.undo()


def _text(tts, text):
    tok = tts.tokenizer.text_to_tokens(text)[0]
    sot, eot = TINY.t3.start_text_token, TINY.t3.stop_text_token
    return np.concatenate([[sot], np.asarray(tok).reshape(-1), [eot]]).astype(np.int32)[None]


def _both(pair, text, *, block=8, max_new_tokens=24, seed=5, sample=SAMPLE):
    """(JAX FirstChunk, its resume, port FirstChunk, its resume) for one text."""
    jax_tts, port = pair
    g = jax_tts._gen_device(jax_tts.conds.gen)
    jfc, jres = jstreaming.first_chunk(
        jax_tts.t3_params, jax_tts.s3gen_params, jax_tts.conds.t3, _text(jax_tts, text),
        prompt_tokens=g["prompt_token"], prompt_feat=g["prompt_feat"],
        embedding=g["embedding"], block_tokens=block, max_new_tokens=max_new_tokens,
        seed=seed, cfg=TINY, **sample)
    pt, pf, emb = port._gen_tensors(port.conds.gen)
    tfc, tres = tstreaming.first_chunk(
        port.t3_params, port.s3gen_params, port.conds.t3, _text(port, text),
        prompt_tokens=pt, prompt_feat=pf, embedding=emb, block_tokens=block,
        max_new_tokens=max_new_tokens, cfg=TINY, draws=JaxDraws(seed), device="cpu", **sample)
    return jfc, jres, tfc, tres


def _assert_fields(jfc, tfc):
    np.testing.assert_array_equal(tfc.tokens.numpy(), np.asarray(jfc.tokens))
    assert int(tfc.n_new) == int(jfc.n_new)
    assert int(tfc.n_valid_mel) == int(jfc.n_valid_mel)
    assert int(tfc.state.i) == int(jfc.state.i)
    np.testing.assert_array_equal(tfc.state.done.numpy(), np.asarray(jfc.state.done))
    assert tfc.wav.shape == tuple(jfc.wav.shape)
    np.testing.assert_allclose(tfc.wav.numpy(), np.asarray(jfc.wav), **WAV)
    np.testing.assert_allclose(tfc.mu_tail.numpy(), np.asarray(jfc.mu_tail), **TIGHT)
    np.testing.assert_allclose(tfc.mel_tail.numpy(), np.asarray(jfc.mel_tail), **TIGHT)
    np.testing.assert_allclose(tfc.phase_carry.numpy(), np.asarray(jfc.phase_carry), **TIGHT)


@pytest.mark.parametrize("text", TEXTS)
def test_first_chunk_matches_jax(pair, text):
    """Two text lengths of one bucket: the left pad is a device value of
    the one program (JAX traces it)."""
    jfc, _, tfc, tres = _both(pair, text)
    _assert_fields(jfc, tfc)
    assert int(tfc.n_new) == 8 and int(tfc.n_valid_mel) == 2 * (8 - 3)
    assert tres["route"] == "eager" and tres["decode_steps"] == 8
    assert tt3.LAST_GENERATION_INFO["fused_first_chunk"] is True
    assert tres["ginfo"]["pad"] == 48 - _text(pair[1], text).shape[1]


def test_first_chunk_other_sampling_values_match_jax(pair):
    """The sampling values are the program's inputs (a graph's, on the
    card), top-p on: the same fields as JAX's."""
    sample = dict(temperature=0.9, cfg_weight=0.3, repetition_penalty=1.4, min_p=0.1,
                  top_p=0.8)
    jfc, _, tfc, tres = _both(pair, TEXTS[1], sample=sample)
    _assert_fields(jfc, tfc)
    assert tres["use_top_p"] and tres["sp"].temperature == np.float32(0.9)


def test_graph_cache_is_bounded_and_released(pair, monkeypatch):
    """GRAPHS keeps the GRAPHS_KEPT most recently used graphs, and a
    pipeline's graphs go when the pipeline does (each holds its pool and
    its model's weights)."""
    import gc
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    cache = tstreaming._GraphCache(2)
    m1, m2, m3 = {}, {}, {}
    for i, m in enumerate((m1, m2, m3, m1)):
        cache.keep(("cpu", (id(m), 0), i), f"graph {i}")
        if i == 2:
            assert cache.lookup(("cpu", (id(m2), 0), 1)) == "graph 1"    # now the newest
    assert list(cache.values()) == ["graph 1", "graph 3"]
    cache.release(m1)
    assert list(cache.values()) == ["graph 1"]
    assert tstreaming.GRAPHS.kept == tstreaming.GRAPHS_KEPT

    port = pair[1]
    monkeypatch.setattr(tstreaming, "GRAPHS", tstreaming._GraphCache(tstreaming.GRAPHS_KEPT))
    tts = ChatterboxTTS(port.t3_params, port.s3gen_params, port.tokenizer, config=TINY,
                        device="cpu")
    key = ("cpu", (id(tts._t3_single["llama"]), id(tts.s3gen_params["flow"])), 48)
    tstreaming.GRAPHS.keep(key, "a graph")
    tstreaming.GRAPHS.keep(("cpu", (id(m2), id(m3)), 48), "another model's")
    del tts
    gc.collect()
    assert list(tstreaming.GRAPHS.values()) == ["another model's"]


def test_continue_tokens_matches_jax(pair):
    jfc, jres, tfc, tres = _both(pair, TEXTS[0], max_new_tokens=40)
    jblocks = list(jstreaming.continue_tokens(pair[0].t3_params, jfc, jres, cfg=TINY))
    tblocks = list(tstreaming.continue_tokens(pair[1].t3_params, tfc, tres, cfg=TINY))
    assert [b.shape for b in tblocks] == [b.shape for b in jblocks] and len(tblocks) == 4
    for a, b in zip(tblocks, jblocks):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tres["decode_steps"] == 40


@pytest.mark.parametrize("max_new_tokens", [2, 5])
def test_first_chunk_short_limits_match_jax(pair, max_new_tokens):
    """A limit below the block: 2 leaves nothing emittable (the degenerate
    case, n_valid_mel 0), 5 emits 2 * (5 - 3) frames; the steps past the
    limit run and change nothing."""
    jfc, _, tfc, tres = _both(pair, TEXTS[1], max_new_tokens=max_new_tokens)
    _assert_fields(jfc, tfc)
    assert int(tfc.n_new) == max_new_tokens
    assert int(tfc.n_valid_mel) == 2 * max(max_new_tokens - 3, 0)
    assert not tfc.tokens[max_new_tokens:].any()
    # the per-block route's capacity (K1 splits its walk by the capacity, so
    # the two routes agree on the card only at one capacity)
    _, ginfo = tt3.start_generation(pair[1].t3_params, pair[1].conds.t3, _text(pair[1], TEXTS[1]),
                                    cfg_weight=0.5, max_new_tokens=max_new_tokens, cfg=TINY.t3,
                                    device="cpu")
    assert tfc.state.cache.k.shape[1] == tres["ginfo"]["cache_total"] == ginfo["cache_total"]


def test_first_chunk_eos_inside_the_block():
    """A row that samples EOS at step 3 stops the block there: n_new 4, the
    EOS slot becomes the flow's pad id and the later tokens are zero, the
    counts and the state's step stop with it (the JAX while-loop's exit),
    although every step of the block ran."""
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    tts = ChatterboxTTS.from_random(seed=1, config=tiny_port_config(), device="cpu")
    tts.conds = tiny_conds(tts.cfg)
    eos = tts.cfg.t3.stop_speech_token

    class EosAt3(Draws):
        def gumbel(self, step, shape):
            g = super().gumbel(step, shape)
            if step == 3:
                g[..., eos] = 1e9
            return g

    pt, pf, emb = tts._gen_tensors(tts.conds.gen)
    fc, res = tstreaming.first_chunk(
        tts.t3_params, tts.s3gen_params, tts.conds.t3, _text(tts, TEXTS[0]), prompt_tokens=pt,
        prompt_feat=pf, embedding=emb, block_tokens=8, max_new_tokens=24,
        cfg=tts.cfg, draws=EosAt3(0, "cpu"), device="cpu", **dict(SAMPLE, min_p=0.0))
    assert int(fc.n_new) == 4 and int(fc.state.i) == 4 and bool(fc.state.done.all())
    assert int(fc.tokens[3, 0]) == eos and not fc.tokens[4:].any()
    assert int(fc.n_valid_mel) == 0               # 3 valid tokens, all pre-lookahead
    assert int(fc.state.counts[0, eos]) == 1
    assert int(fc.state.counts.sum()) == 1 + 4    # the start token and 4 samples
    assert list(tstreaming.continue_tokens(tts.t3_params, fc, res, cfg=tts.cfg)) == []


@pytest.mark.parametrize("kw", [
    dict(block_tokens=8, throughput_block_tokens=8, max_new_tokens=32, cfg_weight=0.3, seed=9),
    dict(block_tokens=8, throughput_block_tokens=8, max_new_tokens=2, cfg_weight=0.3, seed=9),
], ids=["stream", "degenerate"])
def test_stream_fused_route_equals_per_block_route(pair, monkeypatch, kw):
    """Within the port, with its default draws: the first-chunk route and
    the per-block route give the same chunks (the JAX package's
    test_stream_fused_equals_unfused and its degenerate case)."""
    _, port = pair
    monkeypatch.setenv("CHATTERBOX_FUSED_FIRST_CHUNK", "0")
    plain = list(port.stream_generate("The fused and per-block routes agree.", **kw))
    assert port.perf["fused_first_chunk"] is False
    monkeypatch.setenv("CHATTERBOX_FUSED_FIRST_CHUNK", "1")
    fused = list(port.stream_generate("The fused and per-block routes agree.", **kw))
    assert port.perf["fused_first_chunk"] is True
    assert port.perf["first_chunk_graph"] == "eager"
    assert len(fused) == len(plain) >= (2 if kw["max_new_tokens"] > 8 else 1)
    for a, b in zip(fused, plain):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **ROUTES)
    assert port.perf["decode_steps"] >= kw["max_new_tokens"]


def test_stream_short_limit_matches_jax_fused_route(pair, monkeypatch):
    """max_new_tokens 5 < block 8: the program emits 2 * (5 - 3) frames and
    the final window the rest, in both packages' first-chunk routes."""
    jax_tts, port = pair
    kw = dict(block_tokens=8, throughput_block_tokens=8, max_new_tokens=5, cfg_weight=0.3,
              seed=9)
    monkeypatch.setenv("CHATTERBOX_FUSED_FIRST_CHUNK", "1")
    ref = list(jax_tts.stream_generate("Hi.", **kw))
    out = list(port.stream_generate("Hi.", draws=JaxDraws(9), **kw))
    assert [c.shape for c in out] == [c.shape for c in ref] and len(out) == 2
    assert out[0].size == 2 * 2 * 480
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, **WAV)


def test_nothing_separate_runs_before_the_first_chunk(pair, monkeypatch):
    """The first yielded chunk comes from the first-chunk program alone:
    none of the separate prefill, decode_block, flow_to_mel_window or
    stream_synthesize calls runs before it (the JAX package's
    test_stream_first_chunk_single_dispatch). The program's own body calls
    some of them (on the card it is one graph replay); those calls do not
    count. After the first chunk the per-block loop takes over."""
    _, port = pair
    calls, inside = [], []
    body = tstreaming._first_chunk_body

    def body_spy(*a, **k):
        inside.append(True)
        try:
            return body(*a, **k)
        finally:
            inside.pop()

    monkeypatch.setattr(tstreaming, "_first_chunk_body", body_spy)
    for mod, name in ((tt3, "prefill"), (tt3, "start_generation"), (tt3, "decode_block"),
                      (ts3, "flow_to_mel_window"), (thift, "stream_synthesize")):
        orig = getattr(mod, name)

        def spy(*a, __orig=orig, __name=name, **k):
            if not inside:
                calls.append(__name)
            return __orig(*a, **k)

        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setenv("CHATTERBOX_FUSED_FIRST_CHUNK", "1")
    it = port.stream_generate("Hello streaming world, fused this time.", block_tokens=8,
                              max_new_tokens=32, cfg_weight=0.3, seed=5)
    first = next(it)
    assert first.size > 0 and np.isfinite(first).all()
    assert calls == [], f"separate calls ran before the first chunk: {calls}"
    assert tt3.LAST_GENERATION_INFO["fused_first_chunk"] is True
    rest = list(it)
    assert "decode_block" in calls and "flow_to_mel_window" in calls
    assert "prefill" not in calls and "start_generation" not in calls
    total = np.concatenate([first] + rest)
    assert np.isfinite(total).all() and total.size == 2 * 480 * port.perf["speech_tokens"]


def test_int8_kv_leaves_the_first_chunk_cache_in_the_compute_dtype(pair, monkeypatch):
    """CHATTERBOX_INT8_KV=1: the first chunk prefills a compute-dtype cache
    (the JAX package's first chunk calls prefill without kv_int8), so its
    tokens equal those without the setting, and the decode resumes on it."""
    ref = _both(pair, TEXTS[0], max_new_tokens=24)[2]
    monkeypatch.setenv("CHATTERBOX_INT8_KV", "1")
    jfc, _, tfc, tres = _both(pair, TEXTS[0], max_new_tokens=24)
    assert tfc.state.cache.k.dtype == torch.float32 and tfc.state.cache.k_scale is None
    assert tt3.LAST_GENERATION_INFO["kv_int8"] is False
    np.testing.assert_array_equal(tfc.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_array_equal(tfc.tokens.numpy(), np.asarray(jfc.tokens))
    blocks = list(tstreaming.continue_tokens(pair[1].t3_params, tfc, tres, cfg=TINY))
    assert sum(b.size for b in blocks) == 16


class _HostWaits(TorchDispatchMode):
    """What a CUDA graph capture refuses, on the CPU: an operation that
    reads a tensor's value on the host (item, bool, int), makes a tensor
    from host data (torch.tensor) or sizes its output by the data (nonzero,
    a boolean-mask index, masked_select, unique, repeat_interleave by a
    tensor)."""
    REFUSED = ("_local_scalar_dense", "lift_fresh", "nonzero", "masked_select", "_unique",
               "repeat_interleave.Tensor")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if any(r in name for r in self.REFUSED):
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("step", ["default", "fused", "defer"])
def test_first_chunk_body_never_waits_on_the_host(pair, monkeypatch, step):
    """The body the card captures, run eagerly after a first run (which
    makes the device constants): no host read of a device value and no
    tensor made from host data, on the default step (K1), K4 and K1s; and
    the second run gives the first's chunk."""
    env = {"default": {}, "fused": {"CHATTERBOX_FUSED_STEP": "1"},
           "defer": {"CHATTERBOX_DEFER_KV": "1"}}[step]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _, port = pair
    pt, pf, emb = port._gen_tensors(port.conds.gen)
    kw = dict(prompt_tokens=pt, prompt_feat=pf, embedding=emb, block_tokens=8,
              max_new_tokens=24, cfg=TINY, device="cpu", **SAMPLE)
    first, _ = tstreaming.first_chunk(port.t3_params, port.s3gen_params, port.conds.t3,
                                      _text(port, TEXTS[0]), draws=JaxDraws(3), **kw)
    assert tt3.LAST_GENERATION_INFO["use_fused"] is (step == "fused")
    run = _body_run(port, _text(port, TEXTS[0]), JaxDraws(3), pt, pf, emb)
    created = []
    monkeypatch.setattr(torch, "from_numpy", lambda a: created.append(a.shape) or None)
    guard = _HostWaits()
    with guard:
        again = run()
    assert guard.seen == [] and created == []
    for a, b in zip(again[1:], first[1:]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _body_run(port, tt, draws, pt, pf, emb):
    """A call of streaming._first_chunk_body with first_chunk's inputs and
    draws for `tt`, all made here, before the call."""
    t3c = TINY.t3
    pad, p_len, cap = tt3._capacity(tt.shape[1], port.conds.t3, t3c, True, 24)
    total = -(-cap // tt3.CACHE_ALIGN) * tt3.CACHE_ALIGN
    use_fused = tt3._fused_gate(port.t3_params, t3c, 1, True, False, None)
    fused = tt3._fused_params(port.t3_params, t3c, torch.float32) if use_fused else None
    sp = torch.tensor([SAMPLE[k] for k in (
        "temperature", "cfg_weight", "repetition_penalty", "min_p", "top_p")])
    st = tstreaming._Static(8, total, p_len, use_fused, False, 8, torch.float32)
    inp = tstreaming._Inputs(
        torch.from_numpy(np.pad(tt, ((0, 0), (pad, 0))).astype(np.int64)),
        torch.full((), pad, dtype=torch.int32), torch.full((), 24, dtype=torch.int32), sp,
        port.conds.t3.speaker_emb.float(), port.conds.t3.cond_prompt_speech_tokens.int(),
        torch.full((1,), 0.5), pt, pf, emb)
    gumbels = [draws.gumbel(i, (1, t3c.speech_tokens_dict_size)) for i in range(8)]
    nh = TINY.s3gen.hift.nb_harmonics + 1
    phase = draws.stream_phase((1, nh, 1))
    noise = draws.window_noise(0, (1, nh, 2 * 11 * 480))

    class Made:
        def gumbel(self, step, shape):
            return gumbels[step]

        def stream_phase(self, shape):
            return phase

        def window_noise(self, window, shape):
            return noise

    return lambda: tstreaming._first_chunk_body(port.t3_params, port.s3gen_params, inp,
                                                Made(), st, fused, TINY)


def test_kernel_wrappers_take_a_device_start(rng):
    """K1, K1s and K4 take the start as a one-element int32 tensor (their
    plain versions here), equal to the int start."""
    b, h, d, lc = 2, 4, 64, 64
    q = torch.from_numpy(rng.standard_normal((b, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((lc, b, h, d)).astype(np.float32))
            for _ in range(2))
    # (device start, the int start it equals): a negative one is taken as 0
    for dev_start, start in ((0, 0), (5, 5), (30, 30), (-1, 0)):
        st = torch.tensor([dev_start], dtype=torch.int32)
        np.testing.assert_array_equal(tfd.decode_attention(q, k, v, 40, st).numpy(),
                                      tfd.decode_attention(q, k, v, 40, start).numpy())
        np.testing.assert_array_equal(
            tfd.decode_attention(q, k, v, 40, st, k_cur=q, v_cur=q).numpy(),
            tfd.decode_attention(q, k, v, 40, start, k_cur=q, v_cur=q).numpy())
        np.testing.assert_array_equal(tfd.walk_reference(q, k, v, 40, st).numpy(),
                                      tfd.walk_reference(q, k, v, 40, start).numpy())
    from chatterbox_embed_tpu_torch.config import LlamaConfig
    from chatterbox_embed_tpu_torch.models import layers as tL
    from chatterbox_embed_tpu_torch.models import llama as tl
    cfg = LlamaConfig(hidden_size=128, intermediate_size=256, num_layers=2, num_heads=2,
                      num_kv_heads=2, head_dim=64)
    fused = tfu.stack_for_fused(tl.init(tL.Init(0, device="cpu"), cfg), cfg, torch.float32)
    x = torch.from_numpy(rng.standard_normal((b, 128)).astype(np.float32))
    cache = torch.from_numpy(rng.standard_normal((2, 2, lc, b, 2, d)).astype(np.float32))
    for dev_start, start in ((0, 0), (7, 7), (-1, 0)):
        outs = [tfu.fused_decode_step(fused, x, cache[0].clone(), cache[1].clone(), 40, s, cfg,
                                      torch.float32)
                for s in (start, torch.tensor([dev_start], dtype=torch.int32))]
        for a, b_ in zip(*outs):
            np.testing.assert_array_equal(a.numpy(), b_.numpy())
