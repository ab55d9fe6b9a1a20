"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
JAX's own random draws as a draw source for the port, parameter-tree
conversion for single modules, and a tiny pipeline built in both packages
from the same random weights."""
import numpy as np
import torch
import jax
import jax.numpy as jnp

from chatterbox_embed_tpu_torch.models import layers as L
from chatterbox_embed_tpu_torch.weights import convert_tree


class JaxDraws:
    """The draws the JAX package makes from PRNGKey(seed), in the port's
    draw-source interface (chatterbox_embed_tpu_torch.ops.sampling.Draws):
    T3 step i samples with fold_in(key, i) (t3.py decode_block), the HiFT
    source splits the key in 3 for phase and noise (hifigan.sine_source),
    a streamed window draws as hifigan._stream_impl does, and a flow
    training step as cfm.compute_loss does."""

    def __init__(self, seed: int = 0):
        self.key = jax.random.PRNGKey(seed)

    def gumbel(self, step, shape):
        k = jax.random.fold_in(self.key, step)
        return torch.from_numpy(np.array(jax.random.gumbel(k, shape, jnp.float32)))

    def phase(self, shape):
        k_phase = jax.random.split(self.key, 3)[0]
        return torch.from_numpy(np.array(
            jax.random.uniform(k_phase, shape, jnp.float32, -jnp.pi, jnp.pi)))

    def noise(self, shape):
        k_noise = jax.random.split(self.key, 3)[1]
        return torch.from_numpy(np.array(jax.random.normal(k_noise, shape, jnp.float32)))

    def stream_phase(self, shape):
        """Streaming: the phases come from the utterance key itself
        (hifigan._stream_impl)."""
        return torch.from_numpy(np.array(
            jax.random.uniform(self.key, shape, jnp.float32, -jnp.pi, jnp.pi)))

    def window_noise(self, window, shape):
        """Streaming: window k's noise key is fold_in(key, k)
        (streaming.WindowedSynth, first_chunk)."""
        k = jax.random.fold_in(self.key, window)
        return torch.from_numpy(np.array(jax.random.normal(k, shape, jnp.float32)))

    def flow_train(self, rows, shape):
        """A flow-matching training step: split(key, 3) for the time, the
        noise and the CFG keep draw (cfm.compute_loss)."""
        k_t, k_z, k_cfg = jax.random.split(self.key, 3)
        return tuple(torch.from_numpy(np.array(a)) for a in (
            jax.random.uniform(k_t, (rows,), jnp.float32),
            jax.random.normal(k_z, shape, jnp.float32),
            jax.random.uniform(k_cfg, (rows,))))


def port_params(init_fn, cfg, jax_params, name="module"):
    """A JAX module's params converted into the port's tree for `init_fn`."""
    return convert_tree(init_fn(L.Init(device="meta"), cfg), jax_params, name)


def t(a, dtype=None):
    """numpy / jax array -> torch tensor."""
    x = torch.from_numpy(np.array(a))
    return x if dtype is None else x.to(dtype)


def tiny_pipeline_config():
    """A ChatterboxConfig small enough for CPU tests: 2-layer 64-wide T3, one
    conformer block of each kind, a 1-block CFM estimator, a 32-channel HiFT."""
    from chatterbox_embed_tpu.config import (ChatterboxConfig, ConformerConfig,
                                             FlowDecoderConfig, HiFTConfig, LlamaConfig,
                                             S3GenConfig, S3TokenizerConfig, T3Config, replace)
    return ChatterboxConfig(
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


def tiny_tts_pair(cfg, monkeypatch):
    """(jax_tts, port): the JAX pipeline from_random(seed=0) at `cfg`, and
    the port built from its weights, both with the same random prepared
    conditionals. The JAX package's default buckets are set through
    `monkeypatch` (another test file may narrow them)."""
    import chatterbox_embed_tpu.models.t3 as jt3
    import chatterbox_embed_tpu.tts as jtts
    from chatterbox_embed_tpu.conditionals import Conditionals as JConditionals
    from chatterbox_embed_tpu_torch.conditionals import Conditionals
    from chatterbox_embed_tpu_torch.models.t3 import T3Cond
    from chatterbox_embed_tpu_torch.models.tokenizer import FallbackTokenizer
    from chatterbox_embed_tpu_torch.tts import ChatterboxTTS
    from chatterbox_embed_tpu_torch.weights import from_jax_params
    monkeypatch.setattr(jt3, "_TEXT_BUCKETS", (48, 96, 192, 384, 768))
    monkeypatch.setattr(jtts, "_TOKEN_BUCKETS", (128, 256, 512, 1024))
    rng = np.random.default_rng(11)
    spk = rng.standard_normal((1, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (1, 8)).astype(np.int32)
    gen = dict(prompt_token=prompt.astype(np.int64), prompt_token_len=np.array([8]),
               prompt_feat=rng.standard_normal((1, 16, cfg.s3gen.mel_num)).astype(np.float32),
               prompt_feat_len=None,
               embedding=rng.standard_normal((1, 192)).astype(np.float32))
    jax_tts = jtts.ChatterboxTTS.from_random(seed=0, config=cfg)
    jax_tts.conds = JConditionals(jt3.T3Cond(jnp.asarray(spk), jnp.asarray(prompt), 0.5), gen)
    state = from_jax_params(jax_tts.t3_params, jax_tts.s3gen_params, cfg)
    port = ChatterboxTTS(state["t3"], state["s3gen"], FallbackTokenizer(cfg.t3),
                         conds=Conditionals(T3Cond(t(spk), t(prompt), 0.5), gen), config=cfg, device="cpu")
    return jax_tts, port
