"""The port's ChatterboxTTS.generate against the JAX package's, end to end at
a tiny config: the JAX pipeline's random weights go through
weights.from_jax_params into the port, both get the same Conditionals, and
the port draws JAX's own random numbers. Speech tokens must be equal; the
wav agrees to 1e-3 absolute (the HiFT bound of test_torch_s3gen.py)."""
import sys
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from chatterbox_embed_tpu.config import (ChatterboxConfig, ConformerConfig, FlowDecoderConfig,
                                         HiFTConfig, LlamaConfig, S3GenConfig,
                                         S3TokenizerConfig, T3Config, replace)
from chatterbox_embed_tpu.conditionals import Conditionals as JConditionals
from chatterbox_embed_tpu.models.t3 import T3Cond as JT3Cond
from chatterbox_embed_tpu_torch.conditionals import Conditionals
from chatterbox_embed_tpu_torch.models.t3 import T3Cond
from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer
from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
from chatterbox_embed_tpu_torch.weights import from_jax_params
from torch_parity import JaxDraws, t

torch.set_num_threads(2)
TINY = ChatterboxConfig(
    t3=T3Config(
        llama=LlamaConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                          num_heads=4, num_kv_heads=4, head_dim=16),
        max_text_tokens=64, max_speech_tokens=128, speech_cond_prompt_len=8),
    s3gen=S3GenConfig(
        flow=replace(S3GenConfig().flow,
                     encoder=ConformerConfig(input_size=32, output_size=32,
                                             attention_heads=4, linear_units=64,
                                             num_blocks=1, num_up_blocks=1),
                     decoder=FlowDecoderConfig(in_channels=32, out_channels=8,
                                               channels=16, attention_head_dim=8,
                                               num_heads=2, n_blocks=1, num_mid_blocks=1,
                                               time_embed_dim=64),
                     input_size=32, output_size=8),
        hift=HiFTConfig(in_channels=8, base_channels=32, f0_cond_channels=16),
        tokenizer=S3TokenizerConfig(n_state=64, n_heads=4, n_layers=1),
        mel_num=8,
    ),
)
TEXT = "Hello from the port."
GEN = dict(max_new_tokens=60, cfg_weight=0.5, temperature=0.7, seed=3)


def _conds():
    rng = np.random.default_rng(11)
    spk = rng.standard_normal((1, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (1, 8)).astype(np.int32)
    gen = dict(prompt_token=prompt.astype(np.int64), prompt_token_len=np.array([8]),
               prompt_feat=rng.standard_normal((1, 16, 8)).astype(np.float32),
               prompt_feat_len=None,
               embedding=rng.standard_normal((1, 192)).astype(np.float32))
    return (JConditionals(JT3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5), gen),
            Conditionals(T3Cond(t(spk), t(prompt), 0.5), gen))


@pytest.fixture(scope="module")
def pair():
    import chatterbox_embed_tpu.models.t3 as jt3
    import chatterbox_embed_tpu.tts as jtts
    mp = pytest.MonkeyPatch()
    # the JAX package's default buckets (another test file may narrow them)
    mp.setattr(jt3, "_TEXT_BUCKETS", (48, 96, 192, 384, 768))
    mp.setattr(jtts, "_TOKEN_BUCKETS", (128, 256, 512, 1024))
    jax_tts = jtts.ChatterboxTTS.from_random(seed=0, config=TINY)
    jconds, conds = _conds()
    jax_tts.conds = jconds
    state = from_jax_params(jax_tts.t3_params, jax_tts.s3gen_params, TINY)
    port = ChatterboxTTS(state["t3"], state["s3gen"], FallbackTokenizer(TINY.t3),
                         conds=conds, config=TINY, device="cpu")
    yield jax_tts, port
    mp.undo()


def test_generate_matches_jax(pair):
    jax_tts, port = pair
    sample = dict(temperature=0.7, cfg_weight=0.5, repetition_penalty=1.2, min_p=0.05,
                  top_p=1.0, max_new_tokens=60, seed=3)
    jtok = jax_tts._run_t3(TEXT, jax_tts.conds, **sample)
    info = {}
    ttok = port._run_t3(TEXT, port.conds, draws=JaxDraws(3), info=info, **sample)
    np.testing.assert_array_equal(ttok, jtok)
    assert len(ttok) >= 8
    jwav = jax_tts.generate(TEXT, **GEN)
    wav = port.generate(TEXT, draws=JaxDraws(3), **GEN)
    assert wav.shape == jwav.shape == (1, 2 * len(ttok) * 480)
    np.testing.assert_allclose(wav, jwav, atol=1e-3)
    assert port.perf["speech_tokens"] == len(ttok)
    assert port.perf["decode_steps"] >= len(ttok)


def test_default_draws_are_seeded(pair):
    _, port = pair
    a = port.generate(TEXT, **GEN)
    b = port.generate(TEXT, **GEN)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).all() and a.shape[1] == 2 * port.perf["speech_tokens"] * 480


def test_generate_needs_conds(pair):
    _, port = pair
    bare = ChatterboxTTS(port.t3_params, port.s3gen_params, port.tokenizer, config=TINY, device="cpu")
    with pytest.raises(RuntimeError, match="Conditionals are not prepared"):
        bare.generate(TEXT)


def test_from_jax_params_fails_loudly(pair):
    jax_tts, _ = pair
    t3p = dict(jax_tts.t3_params)
    t3p["extra"] = {"w": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="no place in the port"):
        from_jax_params(t3p, jax_tts.s3gen_params, TINY)
    t3p = dict(jax_tts.t3_params)
    del t3p["speech_head"]
    with pytest.raises(KeyError, match="speech_head"):
        from_jax_params(t3p, jax_tts.s3gen_params, TINY)
    wide = replace(TINY, t3=replace(TINY.t3, llama=replace(TINY.t3.llama, intermediate_size=96)))
    with pytest.raises(ValueError, match="shape"):
        from_jax_params(jax_tts.t3_params, jax_tts.s3gen_params, wide)


def test_conds_pt_roundtrip(tmp_path):
    jconds, conds = _conds()
    path = str(tmp_path / "conds.pt")
    conds.save(path)
    back = Conditionals.load(path, device="cpu")
    np.testing.assert_array_equal(back.t3.speaker_emb.numpy(), conds.t3.speaker_emb.numpy())
    np.testing.assert_array_equal(back.t3.cond_prompt_speech_tokens.numpy(),
                                  conds.t3.cond_prompt_speech_tokens.numpy())
    assert back.t3.emotion_adv == 0.5
    np.testing.assert_array_equal(back.gen["prompt_feat"], conds.gen["prompt_feat"])
    # the JAX package reads the port's file, and the other way round
    jback = JConditionals.load(path)
    np.testing.assert_array_equal(np.asarray(jback.t3.speaker_emb), conds.t3.speaker_emb.numpy())
    jconds.save(str(tmp_path / "jconds.pt"))
    back = Conditionals.load(str(tmp_path / "jconds.pt"), device="cpu")
    np.testing.assert_array_equal(back.t3.speaker_emb.numpy(), conds.t3.speaker_emb.numpy())


def test_from_random_full_width_tree_shapes():
    """from_random at the full ChatterboxConfig() builds the tree
    from_jax_params expects (shape-only on the meta device)."""
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.models import t3 as tt3
    tree = tt3.init(L.Init(device="meta"), ChatterboxConfig().t3)
    assert len(tree["llama"]["layers"]) == 30
    assert tuple(tree["llama"]["layers"][0]["gate"]["w"].shape) == (1024, 4096)


def stub_checkpoint(port, folder, monkeypatch):
    """A tiny checkpoint folder for from_local: tokenizer.json and conds.pt
    written, the safetensors reads and the port's numpy converters stubbed
    to hand back `port`'s trees (and a voice encoder's) as arrays in the
    port's layout (no reference checkpoint exists here;
    test_torch_weights.py holds the real converters against the JAX
    package's). Returns (the paths read, the voice encoder's tree)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from chatterbox_embed_tpu_torch.models import layers as L
    from chatterbox_embed_tpu_torch.models import voice_encoder as tve
    from chatterbox_embed_tpu_torch.utils import weights as tw

    def arrays(tree):
        if isinstance(tree, dict):
            return {k: arrays(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [arrays(v) for v in tree]
        return tree.numpy()

    ve = tve.init(L.Init(1, device="cpu"), TINY.voice_encoder)
    read = []
    monkeypatch.setattr(tw, "load_safetensors", lambda p: read.append(p) or {"path": p})
    monkeypatch.setattr(tw, "convert_voice_encoder", lambda sd: arrays(ve))
    monkeypatch.setattr(tw, "convert_t3", lambda sd, num_layers: arrays(port.t3_params))
    monkeypatch.setattr(tw, "convert_s3gen", lambda sd, cfg: arrays(port.s3gen_params))
    vocab = {"[UNK]": 0, "[START]": 1, "[STOP]": 2, "[SPACE]": 3, "hello": 4, "port": 5}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split("[SPACE]", "isolated")
    tok.save(str(folder / "tokenizer.json"))
    port.conds.save(str(folder / "conds.pt"))
    return read, ve


class StandInHub:
    """A stand-in `huggingface_hub` module (monkeypatched into sys.modules,
    so no test reaches the network): hf_hub_download(repo_id, filename)
    records the request and returns the file's path in `folder`."""

    def __init__(self, folder):
        self.folder, self.asked = folder, []
        self.module = types.ModuleType("huggingface_hub")
        self.module.hf_hub_download = self.download

    def download(self, repo_id, filename, **kw):
        self.asked.append((repo_id, filename))
        return str(self.folder / filename)


CHECKPOINT_FILES = ["ve.safetensors", "t3_cfg.safetensors", "s3gen.safetensors",
                    "tokenizer.json", "conds.pt"]


def test_from_local_wires_converters_tokenizer_and_conds(pair, tmp_path, monkeypatch):
    """from_local reads ve / t3_cfg / s3gen safetensors through the port's
    own numpy converters (utils/weights.py), then weights.from_arrays;
    tokenizer.json through EnTokenizer; conds.pt when present (the
    converters stubbed: stub_checkpoint)."""
    jax_tts, port = pair
    read, ve = stub_checkpoint(port, tmp_path, monkeypatch)
    loaded = ChatterboxTTS.from_local(tmp_path, config=TINY, device="cpu")
    assert [p.rsplit("/", 1)[-1] for p in read] == ["ve.safetensors", "t3_cfg.safetensors",
                                                    "s3gen.safetensors"]
    assert loaded.tokenizer.encode("hello port") == [4, 3, 5]
    np.testing.assert_array_equal(loaded.conds.t3.speaker_emb.numpy(),
                                  port.conds.t3.speaker_emb.numpy())
    np.testing.assert_array_equal(loaded.t3_params["speech_head"]["w"].numpy(),
                                  port.t3_params["speech_head"]["w"].numpy())
    np.testing.assert_array_equal(loaded.ve_params["lstm"][2]["wh"].numpy(),
                                  ve["lstm"][2]["wh"].numpy())


def test_from_pretrained_downloads_the_checkpoint_then_loads_it(pair, tmp_path, monkeypatch):
    """from_pretrained asks the hub for the five files of
    ResembleAI/chatterbox (the JAX package's list and order), then loads
    their folder through from_local with its device and arguments."""
    _, port = pair
    read, _ = stub_checkpoint(port, tmp_path, monkeypatch)
    hub = StandInHub(tmp_path)
    monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module)
    loaded = ChatterboxTTS.from_pretrained(device="cpu", config=TINY, int8=False)
    assert hub.asked == [("ResembleAI/chatterbox", f) for f in CHECKPOINT_FILES]
    assert [p.rsplit("/", 1)[-1] for p in read] == CHECKPOINT_FILES[:3]
    assert loaded.device == torch.device("cpu") and loaded.cfg == TINY
    assert loaded.tokenizer.encode("hello port") == [4, 3, 5]
    np.testing.assert_array_equal(loaded.t3_params["speech_head"]["w"].numpy(),
                                  port.t3_params["speech_head"]["w"].numpy())
    np.testing.assert_array_equal(loaded.conds.t3.speaker_emb.numpy(),
                                  port.conds.t3.speaker_emb.numpy())


def test_from_pretrained_without_huggingface_hub(monkeypatch):
    """Without huggingface_hub it raises, naming from_local (the JAX
    package's message); nothing is loaded."""
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match=r"huggingface_hub unavailable; use from_local\(\)"):
        ChatterboxTTS.from_pretrained(device="cpu", config=TINY)
