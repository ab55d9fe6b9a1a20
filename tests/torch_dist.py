"""Helpers of the mesh tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_train.py) that a mesh's follower processes
import: this module imports the port and torch, never jax or the JAX
package, because a follower re-imports the module of every function and
class the leader sends it. The configs here are the port's own, and the
flow step's draws fixed arrays made on the leader, for the same reason."""
import numpy as np
import torch

from chatterbox_embed_tpu_torch.config import (CFMConfig, ChatterboxConfig, ConformerConfig,
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

# tests/test_parallel.py's pipeline config (4 layers: 4 stages of 1)
PP_TINY = replace(TINY, llama=replace(TINY.llama, num_layers=4))
# tests/test_training.py's TINY T3, and tests/test_torch_training.py's
# 1-block estimator
TRAIN_TINY = T3Config(
    llama=LlamaConfig(hidden_size=32, intermediate_size=64, num_layers=2,
                      num_heads=4, num_kv_heads=4, head_dim=8),
    text_tokens_dict_size=50, speech_tokens_dict_size=40,
    start_speech_token=36, stop_speech_token=37,
    max_text_tokens=32, max_speech_tokens=64,
    speaker_embed_size=8, speech_cond_prompt_len=4)
FLOW_DEC = FlowDecoderConfig(in_channels=32, out_channels=8, channels=16, attention_head_dim=8,
                             num_heads=2, n_blocks=1, num_mid_blocks=1, time_embed_dim=64)
FLOW_CFM = CFMConfig()


class FixedDraws:
    """One flow training step's draws (time, noise, CFG keep) as numpy
    arrays made on the leader (from the JAX package's key there), handed
    to every rank: cfm.compute_loss draws for the whole batch."""

    def __init__(self, t, z, keep):
        self.arrays = (np.asarray(t), np.asarray(z), np.asarray(keep))

    def flow_train(self, rows, shape):
        t, z, keep = self.arrays
        assert t.shape == (rows,) and z.shape == tuple(shape), (t.shape, z.shape, rows, shape)
        return tuple(torch.from_numpy(a.copy()) for a in self.arrays)


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


def axes(mesh):
    """(rank, dp, tp, sp, pp indices, and whether each group is set) of this
    rank of `mesh`."""
    return (mesh.rank, mesh.dp_index, mesh.tp_index, mesh.sp_index, mesh.pp_index,
            tuple(g is not None for g in (mesh.dp_group, mesh.tp_group, mesh.sp_group,
                                          mesh.pp_group)))


def tree_of(params):
    """This rank's tree (shards, or a kept state's params) as plain
    detached tensors."""
    if isinstance(params, dict):
        return {k: tree_of(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [tree_of(v) for v in params]
    return params.detach().clone()


def grads_of(params):
    """The .grad of every leaf of this rank's tree (None stays None)."""
    if isinstance(params, dict):
        return {k: grads_of(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [grads_of(v) for v in params]
    return None if params.grad is None else params.grad.clone()


def pp_loss_and_grads(pp_params, batch, n_micro, cfg, mesh):
    """The pipelined loss and this rank's gradients (its stages', and aux
    summed over pp) from a trainable copy of its shard tree."""
    from chatterbox_embed_tpu_torch.parallel import pipeline
    params = pipeline._trainable(pp_params)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss = pipeline.pp_loss(params, b, mesh.pp, n_micro, cfg, mesh=mesh, backward=True)
    return float(loss), grads_of(params)


def flash_rows(params, draws, batch, mesh):
    """The row counts this rank's flow loss hands the flash-attention
    kernel's wrapper (its plain version on the CPU), counted by wrapping
    it for the one call."""
    from chatterbox_embed_tpu_torch.models import cfm
    from chatterbox_embed_tpu_torch.models import layers as L
    real, rows = L.flash_attention, []
    L.flash_attention = lambda q, *a: rows.append(q.shape[0]) or real(q, *a)
    try:
        b = {k: torch.as_tensor(v) for k, v in batch.items()}
        with torch.no_grad():
            cfm.compute_loss(params, draws, b["mel"], b["mu"], b["spks"], b["cond"], b["mask"],
                             FLOW_CFM, FLOW_DEC, mesh=mesh)
    finally:
        L.flash_attention = real
    return rows


def tf32_switches():
    """This rank's TF32 switches (matmuls, cuDNN)."""
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
