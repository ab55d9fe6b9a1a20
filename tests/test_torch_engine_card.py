"""The engine's graphed step on the card (models/t3_engine.py: EngineStep,
pieced_decode_block) against its eager step (engine_decode_block) on the
same card: 24 requests through the worker's engine geometry (16 slots,
text bucket 256, 1000 new tokens, blocks of 64) with a T3 of 30 layers of
64-wide heads, with the bf16 and the int8 cache. The tokens are equal bit
for bit; K1 runs 30 times a step through llama.decode_attention; every
step after the capture replays the graphs.

The tests need a CUDA card and skip without one. This file imports no
JAX, so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_engine_card.py
"""
import time

import numpy as np
import pytest
import torch

from chatterbox_embed_tpu_torch.config import LlamaConfig, T3Config
from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.models import llama, t3, t3_engine
from chatterbox_embed_tpu_torch.utils import profiling
from chatterbox_embed_tpu_torch.weights import place

# T3 with K1's shapes (30 layers, 64-wide heads) at a quarter of its width
SMALL = T3Config(llama=LlamaConfig(hidden_size=256, intermediate_size=1024, num_layers=30,
                                   num_heads=4, num_kv_heads=4, head_dim=64))
GEO = dict(slots=16, text_bucket=256, max_new_tokens=1000, block=64)
SAMPLING = dict(temperature=0.6, cfg_weight=0.3, repetition_penalty=1.2, min_p=0.05)
REQUESTS = 24


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return torch.device("cuda")


def _inputs(dev):
    rng = np.random.default_rng(0)
    params = place(t3.init(L.Init(0, dev), SMALL), dev, torch.bfloat16)
    conds = [t3.T3Cond(torch.tensor(rng.standard_normal((1, SMALL.speaker_embed_size)),
                                    dtype=torch.float32, device=dev),
                       torch.tensor(rng.integers(0, SMALL.start_speech_token,
                                                 (1, SMALL.speech_cond_prompt_len)),
                                    dtype=torch.int32, device=dev), 0.5)
             for _ in range(2)]
    reqs = []
    for r in range(REQUESTS):
        body = rng.integers(1, SMALL.text_tokens_dict_size, int(rng.integers(20, 250)))
        text = np.concatenate([[SMALL.start_text_token], body, [SMALL.stop_text_token]])
        reqs.append((text[None].astype(np.int32), conds[r % 2], 1000 + r,
                     int(rng.integers(30, 160))))
    return params, reqs


def _drain(params, reqs, kv_int8: bool, graphed: bool):
    dec = t3_engine.ContinuousDecoder(params, SMALL, dtype=torch.bfloat16, kv_int8=kv_int8,
                                      device="cuda", **GEO)
    assert dec.pieces is not None            # the card, no mesh: the pieces
    if not graphed:
        dec.pieces = None
    rids = [dec.submit(text, cond, seed=seed, max_new_tokens=cap, **SAMPLING)
            for text, cond, seed, cap in reqs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = dec.drain()
    torch.cuda.synchronize()
    return dec, [out[r] for r in rids], time.perf_counter() - t0


@pytest.mark.card
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_graphed_engine_equals_the_eager_step_on_the_card(card, kv_int8, monkeypatch):
    params, reqs = _inputs(card)
    eager, want, t_eager = _drain(params, reqs, kv_int8, graphed=False)

    k1 = llama.decode_attention
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return k1(*args, **kwargs)

    monkeypatch.setattr(llama, "decode_attention", counted)
    profiling.reset()
    profiling.enable()
    try:
        dec, got, t_graphed = _drain(params, reqs, kv_int8, graphed=True)
        totals = profiling.totals()
    finally:
        profiling.disable()
        profiling.reset()

    for r, (a, b) in enumerate(zip(want, got, strict=True)):
        np.testing.assert_array_equal(b, a, err_msg=f"request {r}")
    assert (dec.steps_run, dec.blocks_run) == (eager.steps_run, eager.blocks_run)
    assert len(calls) == SMALL.llama.num_layers * dec.steps_run
    # the first step is the eager warm-up before the capture; the rest replay
    assert totals["spans"]["engine.capture"]["calls"] == 1
    assert totals["counters"]["engine.graphed_steps"] == dec.steps_run - 1
    assert len(dec.pieces.graphs.graphs) == SMALL.llama.num_layers + 2
    assert 0 < dec.pieces.graphs.pool_bytes < 1 << 30
    print(f"\n{torch.cuda.get_device_name(card)}, kv_int8={kv_int8}: {dec.steps_run} steps, "
          f"eager {1e3 * t_eager / eager.steps_run:.2f} ms a step, graphed "
          f"{1e3 * t_graphed / dec.steps_run:.2f} (capture included), graphs' pool "
          f"{dec.pieces.graphs.pool_bytes / 2**20:.1f} MiB")
