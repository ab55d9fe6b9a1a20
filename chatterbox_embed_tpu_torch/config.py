"""Configuration: the JAX package's dataclasses, which import no jax, re-exported."""
from chatterbox_embed_tpu.config import (  # noqa: F401
    EOS, S3_HOP, S3_SR, S3_TOKEN_HOP, S3_TOKEN_RATE, S3GEN_SR, SOS,
    SPEECH_VOCAB_SIZE, CAMPPlusConfig, CFMConfig, ChatterboxConfig,
    ConformerConfig, FlowConfig, FlowDecoderConfig, HiFTConfig, LlamaConfig,
    S3GenConfig, S3TokenizerConfig, T3Config, VoiceEncConfig, replace)
