"""Helpers of the mesh tests (tests/test_torch_parallel.py) that a mesh's
follower processes import: this module imports the port and torch, never
jax or the JAX package, because a follower re-imports the module of every
function and class the leader sends it. The configs here are the port's
own, for the same reason."""
import numpy as np
import torch

from chatterbox_embed_tpu_torch.config import (ChatterboxConfig, ConformerConfig,
                                               FlowDecoderConfig, HiFTConfig, LlamaConfig,
                                               S3GenConfig, S3TokenizerConfig, T3Config,
                                               replace)
from chatterbox_embed_tpu_torch.conditionals import Conditionals
from chatterbox_embed_tpu_torch.models import t3

# tests/test_parallel.py's TINY T3 in the port's config
TINY = T3Config(
    llama=LlamaConfig(hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=4, head_dim=16),
    text_tokens_dict_size=50, speech_tokens_dict_size=40,
    start_speech_token=36, stop_speech_token=37,
    max_text_tokens=64, max_speech_tokens=128,
    speaker_embed_size=16, speech_cond_prompt_len=6)


def tiny_pipeline_config() -> ChatterboxConfig:
    """tests/torch_parity.py:tiny_pipeline_config in the port's config."""
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
            mel_num=8))


def tiny_conds(cfg: ChatterboxConfig, seed: int = 11) -> Conditionals:
    """Random prepared conditionals for the tiny pipeline (the voice of
    tests/torch_parity.py:tiny_tts_pair)."""
    rng = np.random.default_rng(seed)
    spk = rng.standard_normal((1, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (1, cfg.t3.speech_cond_prompt_len)).astype(np.int32)
    gen = dict(prompt_token=prompt.astype(np.int64), prompt_token_len=np.array([8]),
               prompt_feat=rng.standard_normal((1, 16, cfg.s3gen.mel_num)).astype(np.float32),
               prompt_feat_len=None,
               embedding=rng.standard_normal((1, 192)).astype(np.float32))
    return Conditionals(t3.T3Cond(torch.from_numpy(spk), torch.from_numpy(prompt), 0.5), gen)


# -- rank functions: run on every rank through Mesh.call_all ----------------

def shard_widths(params, mesh):
    """(rank, dp index, tp index, q columns, k columns, o rows, gate
    columns, down rows, speech-head shape) of this rank's T3 shard."""
    lp = params["llama"]["layers"][0]
    return (mesh.rank, mesh.dp_index, mesh.tp_index, lp["q"]["w"].shape[1],
            lp["k"]["w"].shape[1], lp["o"]["w"].shape[0], lp["gate"]["w"].shape[1],
            lp["down"]["w"].shape[0], tuple(params["speech_head"]["w"].shape))


def generation_info():
    """This rank's t3.LAST_GENERATION_INFO."""
    return dict(t3.LAST_GENERATION_INFO)


def spy_row(params, cond, texts, mesh=None):
    """The alignment spy's head-mean probability row of this rank's CFG
    rows at the first decode step after prefill (llama.forward with
    collect_attn_layer), on `mesh` or alone."""
    from chatterbox_embed_tpu_torch.models import llama
    state, info = t3.start_generation(params, cond, texts, cfg_weight=0.4, max_new_tokens=8,
                                      alignment=True, cfg=TINY, device="cpu", mesh=mesh)
    r0, r1 = info["rows"]
    emb = params["speech_emb"]["w"][3].expand(r1 - r0, 1, -1)
    pos = torch.full((r1 - r0, 1), info["p_len"] - info["pad"], dtype=torch.int64)
    out = llama.forward(params["llama"], emb, pos, cache=state.cache, cache_pos=info["p_len"],
                        cfg=TINY.llama, flash_start=info["pad"],
                        collect_attn_layer=info["align_layer"], mesh=mesh)
    return out[2]


def fail_on(rank, mesh):
    """Raise on mesh rank `rank`; every other rank waits in a sum over the
    mesh, which the failed rank never joins."""
    import torch.distributed as dist
    if mesh.rank == rank:
        raise RuntimeError(f"planted failure on rank {rank}")
    x = torch.ones(1)
    dist.all_reduce(x, group=mesh.group)
    return x


def kept_keys():
    """The keys of the objects this rank keeps for the mesh's calls (a
    follower's; the leader keeps none)."""
    from chatterbox_embed_tpu_torch.parallel import mesh
    return sorted(mesh._OBJECTS)
