"""Cleaning T3's speech tokens before S3Gen: the port's two steps (its own
copy of the SOS / EOS cut, models/s3tokenizer.py:drop_invalid_tokens, then
ids < 6561, models/s3gen.py:drop_invalid_tokens) against the JAX package's
(chatterbox_embed_tpu/tts.py:591-592, 813-814, vc.py:231-232), on id lists
with SOS and EOS anywhere; and two of the port's call sites fed such a
list. Exact: both sides select ids."""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from chatterbox_embed_tpu.config import SPEECH_VOCAB_SIZE
from chatterbox_embed_tpu.models import s3tokenizer as js3tok
from chatterbox_embed_tpu_torch.models import s3gen as ts3gen
from chatterbox_embed_tpu_torch.models import s3tokenizer as ts3tok
from chatterbox_embed_tpu_torch.models import t3 as tt3
from torch_parity import tiny_pipeline_config, tiny_tts_pair

torch.set_num_threads(2)
SOS, EOS = SPEECH_VOCAB_SIZE, SPEECH_VOCAB_SIZE + 1
PLANTED = [1, 2, EOS, 3, 4]          # the issue's witness: [1, 2] against [1, 2, 3, 4]


def _jax_clean(tokens):
    x = js3tok.drop_invalid_tokens(np.asarray(tokens))
    return x[x < SPEECH_VOCAB_SIZE]


def _port_clean(tokens):
    return ts3gen.drop_invalid_tokens(ts3tok.drop_invalid_tokens(np.asarray(tokens)))


ids = st.one_of(st.integers(0, SPEECH_VOCAB_SIZE - 1), st.sampled_from([SOS, EOS]),
                st.integers(SPEECH_VOCAB_SIZE + 2, 8191))


@settings(max_examples=300, deadline=None)
@given(tokens=st.lists(ids, max_size=40), dtype=st.sampled_from([np.int32, np.int64]))
def test_cleaning_equals_the_jax_packages(tokens, dtype):
    x = np.asarray(tokens, dtype)
    np.testing.assert_array_equal(_port_clean(x), _jax_clean(x))
    np.testing.assert_array_equal(_port_clean(x[None]), _jax_clean(x[None]))   # (1, T)


def test_sos_eos_cut_on_the_witness():
    np.testing.assert_array_equal(_port_clean(PLANTED), [1, 2])
    np.testing.assert_array_equal(_port_clean([7, SOS, 5, EOS, 6, EOS]), [5])
    np.testing.assert_array_equal(_port_clean([SOS, 9000, 8, SOS, 3]), [8, 3])
    assert _port_clean([EOS, 1]).size == 0


@pytest.fixture(scope="module")
def port():
    mp = pytest.MonkeyPatch()
    try:
        yield tiny_tts_pair(tiny_pipeline_config(), mp)[1]
    finally:
        mp.undo()


def test_generate_path_cuts_at_the_first_eos(port, monkeypatch):
    """tts._run_t3 (generate, the long-text retries) gets a token list with
    ids after EOS from T3 and returns the JAX package's cleaning of it."""
    monkeypatch.setattr(tt3, "generate", lambda *a, **k: np.asarray(PLANTED, np.int64))
    got = port._run_t3("hi", port.conds, temperature=0.8, cfg_weight=0.5,
                       repetition_penalty=1.2, min_p=0.05, top_p=1.0, max_new_tokens=8,
                       seed=0, draws=None, info={})
    np.testing.assert_array_equal(got, _jax_clean(PLANTED))


def test_batch_path_cuts_at_the_first_eos(port):
    """tts._vocode_batch (generate_batch's S3Gen tail) counts and vocodes
    each row's tokens as the JAX package cleans them."""
    rows = [PLANTED + [5, 6], [SOS, 7, 8, 9, EOS, 10], [11, 12]]
    wavs, lens, _ = port._vocode_batch(rows, conds=port.conds)
    assert lens == [len(_jax_clean(r)) for r in rows] == [2, 3, 2]
    assert all(np.isfinite(w).all() for w in wavs)
