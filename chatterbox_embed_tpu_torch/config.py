"""Configuration dataclasses of the PyTorch port: the port's own copy of
`chatterbox_embed_tpu/config.py`, held equal to it field by field by
tests/test_torch_import.py (the port imports nothing of the JAX package).

Hyperparameters mirror the reference checkpoints so converted weights load
bit-for-bit (reference: models/t3/modules/t3_config.py,
models/t3/llama_configs.py:1-33, models/s3gen/s3gen.py:53-98,
models/voice_encoder/config.py, models/s3gen/configs.py). Flat frozen
dataclasses consumed by the functional models.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


# Global sample rates / token rates (reference: models/s3tokenizer/s3tokenizer.py:15-19,
# models/s3gen/const.py:1)
S3_SR = 16_000            # sample rate consumed by S3 tokenizer & speaker encoders
S3_HOP = 160              # 100 mel frames / sec at 16 kHz
S3_TOKEN_HOP = 640        # 25 speech tokens / sec at 16 kHz
S3_TOKEN_RATE = 25
SPEECH_VOCAB_SIZE = 6561  # 3**8 FSQ codes
S3GEN_SR = 24_000         # output waveform sample rate

SOS = SPEECH_VOCAB_SIZE       # 6561
EOS = SPEECH_VOCAB_SIZE + 1   # 6562


@dataclass(frozen=True)
class LlamaConfig:
    """T3's 0.5B Llama backbone (reference: models/t3/llama_configs.py:1-33)."""
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 30
    num_heads: int = 16
    num_kv_heads: int = 16
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500_000.0
    max_position_embeddings: int = 131_072
    # llama3-style rope scaling
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192


@dataclass(frozen=True)
class T3Config:
    """Token-to-token speech LM (reference: models/t3/modules/t3_config.py:4-27)."""
    start_text_token: int = 255
    stop_text_token: int = 0
    text_tokens_dict_size: int = 704
    max_text_tokens: int = 2048

    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    speech_tokens_dict_size: int = 8194
    max_speech_tokens: int = 4096

    llama: LlamaConfig = field(default_factory=LlamaConfig)
    speech_cond_prompt_len: int = 150
    speaker_embed_size: int = 256
    use_perceiver_resampler: bool = True
    emotion_adv: bool = True

    # perceiver resampler
    perceiver_num_queries: int = 32
    perceiver_num_heads: int = 4

    @property
    def hidden_size(self) -> int:
        return self.llama.hidden_size

    @property
    def max_text_seq_len(self) -> int:
        return self.max_text_tokens + 2

    @property
    def max_speech_seq_len(self) -> int:
        return self.max_speech_tokens + 4

    @property
    def cond_len(self) -> int:
        """Length of the conditioning prefix: spk(1) + prompt(32) + emotion(1)."""
        n = 1
        if self.use_perceiver_resampler:
            n += self.perceiver_num_queries
        if self.emotion_adv:
            n += 1
        return n


@dataclass(frozen=True)
class CFMConfig:
    """Conditional flow matching solver (reference: models/s3gen/configs.py:3-10)."""
    sigma_min: float = 1e-6
    solver: str = "euler"
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7
    n_timesteps: int = 10
    # deterministic noise buffer size: [1, 80, 50*300] (flow_matching.py:191)
    rand_noise_frames: int = 50 * 300


@dataclass(frozen=True)
class ConformerConfig:
    """Token→mel conformer encoder (reference: models/s3gen/s3gen.py:59-74,
    transformer/upsample_encoder.py:99-232)."""
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    pre_lookahead_len: int = 3
    upsample_stride: int = 2
    ln_eps: float = 1e-12  # espnet conformer layers use eps=1e-12
    embed_ln_eps: float = 1e-5


@dataclass(frozen=True)
class FlowDecoderConfig:
    """CFM estimator U-Net (reference: models/s3gen/s3gen.py:76-87, decoder.py:100-218)."""
    in_channels: int = 320
    out_channels: int = 80
    channels: int = 256
    attention_head_dim: int = 64
    num_heads: int = 8
    n_blocks: int = 4          # transformer blocks per resnet stage
    num_mid_blocks: int = 12
    time_embed_dim: int = 1024  # channels[0] * 4


@dataclass(frozen=True)
class FlowConfig:
    """Causal masked-diff flow wrapper (reference: models/s3gen/flow.py:175-234)."""
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    input_frame_rate: int = 25
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    encoder: ConformerConfig = field(default_factory=ConformerConfig)
    decoder: FlowDecoderConfig = field(default_factory=FlowDecoderConfig)
    cfm: CFMConfig = field(default_factory=CFMConfig)


@dataclass(frozen=True)
class HiFTConfig:
    """HiFT-GAN NSF+iSTFT vocoder (reference: models/s3gen/s3gen.py:273-281,
    hifigan.py:286-380)."""
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = S3GEN_SR
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def total_upsample(self) -> int:
        n = self.istft_hop_len
        for r in self.upsample_rates:
            n *= r
        return n  # 480 samples of audio per mel frame


@dataclass(frozen=True)
class CAMPPlusConfig:
    """CAMPPlus x-vector speaker encoder (reference: models/s3gen/xvector.py:340-416)."""
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128
    m_channels: int = 32
    block_layers: Tuple[int, ...] = (12, 24, 16)
    block_kernels: Tuple[int, ...] = (3, 3, 3)
    block_dilations: Tuple[int, ...] = (1, 2, 2)


@dataclass(frozen=True)
class VoiceEncConfig:
    """RTVC-style voice encoder (reference: models/voice_encoder/config.py:1-18)."""
    num_mels: int = 40
    sample_rate: int = 16_000
    speaker_embed_size: int = 256
    ve_hidden_size: int = 256
    n_fft: int = 400
    hop_size: int = 160
    win_size: int = 400
    fmin: float = 0.0
    fmax: float = 8000.0
    mel_power: float = 2.0
    ve_partial_frames: int = 160
    ve_final_relu: bool = True
    stft_magnitude_min: float = 1e-4


@dataclass(frozen=True)
class S3TokenizerConfig:
    """Speech tokenizer v2 (25 Hz) encoder+FSQ.

    The reference wraps the external `s3tokenizer` pip package
    (models/s3tokenizer/s3tokenizer.py:1-12). Architecture follows the public
    package's "speech_tokenizer_v2_25hz" (model_v2.py ModelConfig): 128-mel
    front end, two stride-2 convs (100 Hz -> 25 Hz), 6 SAN-M blocks (FSMN
    memory kernel 31), FSQ with 3**8 = 6561 codes.
    """
    n_mels: int = 128
    n_fft: int = 400
    hop: int = S3_HOP
    n_state: int = 1280
    n_heads: int = 20
    n_layers: int = 6
    fsmn_kernel: int = 31
    fsq_dim: int = 8
    fsq_levels: int = 3            # codes per dim -> 3**8 = 6561 vocab
    vocab_size: int = SPEECH_VOCAB_SIZE


@dataclass(frozen=True)
class S3GenConfig:
    flow: FlowConfig = field(default_factory=FlowConfig)
    hift: HiFTConfig = field(default_factory=HiFTConfig)
    campplus: CAMPPlusConfig = field(default_factory=CAMPPlusConfig)
    tokenizer: S3TokenizerConfig = field(default_factory=S3TokenizerConfig)
    # mel extractor params (reference: models/s3gen/utils/mel.py:33-44)
    mel_n_fft: int = 1920
    mel_num: int = 80
    mel_hop: int = 480
    mel_win: int = 1920
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0


@dataclass(frozen=True)
class ChatterboxConfig:
    """Top-level pipeline config."""
    t3: T3Config = field(default_factory=T3Config)
    s3gen: S3GenConfig = field(default_factory=S3GenConfig)
    voice_encoder: VoiceEncConfig = field(default_factory=VoiceEncConfig)
    # reference conditioning lengths (reference: tts.py:45-46)
    enc_cond_len: int = 6 * S3_SR
    dec_cond_len: int = 10 * S3GEN_SR


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
