"""Training steps for the two trainable model families, the PyTorch
counterpart of `chatterbox_embed_tpu/training/train_step.py`.

- The reference defines the losses but has no trainer; the JAX package
  supplies one, and this is its port: a step per model family, AdamW over
  every leaf (`torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8,
  weight_decay=0.01)`, which is optax.adamw's default with no mask).
- Parameters are the port's trees (the layout `weights.from_jax_params`
  gives) with fp32 leaves that require grad; `init_*_train_state` copies a
  tree onto the device. A step updates them and the optimizer's moments in
  place and returns (state, metrics): the metrics are device tensors, and
  nothing is read back inside the step.
- T3 trains teacher-forced through plain attention; `remat=True` runs each
  Llama layer under torch.utils.checkpoint (the JAX package's
  jax.checkpoint), which moves memory, not gradients.
- The flow step's attention at >= 4 rows is the flash-attention kernel K3
  and its backward K3b (`kernels/flash_attention.py`); its draws (time,
  noise, CFG keep) come from a draw source (`ops/sampling.py:Draws`).
- On a dp x tp mesh (`mesh=`, parallel/mesh.py), as the JAX package's
  steps shard: `shard_t3_state` places the T3 tree Megatron-sharded over
  tp (`t3_param_spec`) and `shard_flow_state` the flow tree replicated,
  each rank's leaves trainable fp32 copies kept on the mesh with an AdamW
  made anew over them (the JAX package re-inits its optimizer). A step
  called on the leader with the whole batch runs on every rank
  (`on_mesh`): each rank takes its rows over dp, divides its loss by the
  whole batch's denominator (t3.loss, cfm.compute_loss), back-propagates
  through the tp collectives, sums its gradients over dp and applies
  AdamW to its shards; replicated leaves stay bit-equal across ranks
  (every rank adds the same sums). The leader gets the global loss and
  metrics. The batch rows must divide dp; the flow step's draws come from
  one source for the whole batch on every rank.
- The step makers return the step alone, with no batch shardings (a rank
  takes its rows itself). An sp or pp mesh is refused: those run
  parallel/sp.py and parallel/pipeline.py.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..config import CFMConfig, FlowDecoderConfig, T3Config
from ..device import resolve_device
from ..models import cfm as cfm_mod
from ..models import backbone
from ..models import t3 as t3_mod
from ..parallel.mesh import Mesh, flow_param_spec, kept, on_mesh, shard_params, t3_param_spec

T3_BATCH_KEYS = ("speaker_emb", "cond_prompt_tokens", "emotion_adv", "text_tokens",
                 "text_lens", "speech_tokens", "speech_lens")
FLOW_BATCH_KEYS = ("mel", "mu", "spks", "cond", "mask")


class TrainState(NamedTuple):
    params: Any                  # the port's tree of fp32 leaves that require grad
    opt_state: torch.optim.AdamW  # its moments; a step updates both in place
    step: int
    # on a mesh, params and opt_state are each rank's, kept on the mesh


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _adamw(params, lr: float = 1e-4, wd: float = 0.01) -> torch.optim.AdamW:
    return torch.optim.AdamW(_leaves(params), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=wd)


def _train_mesh(mesh) -> None:
    """A train step's mesh: None, or a Mesh over dp and tp."""
    if mesh is None:
        return
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be None or a parallel.Mesh, not {type(mesh).__name__}")
    if "dp" not in mesh.axis_names and "tp" not in mesh.axis_names:
        raise ValueError(f"a train step runs on a dp x tp mesh, not on axes {mesh.axis_names} "
                         "(sp: parallel.sp_generate_mel; pp: parallel.pipeline."
                         "make_pp_train_step)")


def _check_state(state, rows: int, mesh) -> None:
    """A mesh step's refusals, on the leader before anything is sent: rows
    that do not divide dp, a state not placed on the mesh."""
    mesh.rows(rows)
    if mesh.leads() and not kept(state.params):
        raise ValueError("the state's params are not on the mesh: shard_t3_state / "
                         "shard_flow_state(state, mesh) first")


def _shard_state(state: TrainState, mesh: Mesh, spec, lr: float) -> TrainState:
    """Each rank's trainable shards of state.params by `spec` and an AdamW
    over them, both kept on the mesh."""
    params = shard_params(state.params, spec, mesh, trainable=True)
    return TrainState(params, mesh.make(_adamw, params, lr), state.step)


def _trainable(params, device):
    """A copy of `params` on `device` with fp32 leaves that require grad."""
    device = resolve_device(device)
    return _map(lambda x: torch.as_tensor(x).detach().to(device=device, dtype=torch.float32)
                .clone().requires_grad_(True), params)


def _on(batch: Dict[str, Any], keys, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], device=device) for k in keys}


def _apply(state: TrainState, lr: float, loss_and_metrics, mesh=None):
    """One AdamW update from the loss that `loss_and_metrics()` computes; on
    a mesh the gradients are summed over dp first, and the returned loss
    and metrics are the dp sums (the whole batch's)."""
    opt = state.opt_state
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss, metrics = loss_and_metrics()
    loss.backward()
    if mesh is not None:
        mesh.sum_grads(_leaves(state.params), "dp")
    opt.step()
    loss, metrics = loss.detach(), {k: v.detach() for k, v in metrics.items()}
    if mesh is not None:
        values = mesh.sum(torch.stack([loss] + list(metrics.values())), "dp")
        loss, metrics = values[0], dict(zip(metrics, values[1:]))
    return loss, metrics


# ---------------------------------------------------------------------------
# T3 (speech LM) training
# ---------------------------------------------------------------------------

def t3_loss_fn(params, batch: Dict[str, torch.Tensor], cfg: T3Config, dtype,
               remat: bool = False, mesh=None):
    """(loss_text + loss_speech, {"loss_text", "loss_speech"}) of a batch of
    T3_BATCH_KEYS tensors (on a mesh: this rank's part, t3.loss)."""
    cond = t3_mod.T3Cond(speaker_emb=batch["speaker_emb"],
                         cond_prompt_speech_tokens=batch["cond_prompt_tokens"],
                         emotion_adv=batch["emotion_adv"])
    loss_text, loss_speech = t3_mod.loss(
        params, cond, batch["text_tokens"], batch["text_lens"],
        batch["speech_tokens"], batch["speech_lens"], cfg, dtype, remat, mesh)
    return loss_text + loss_speech, {"loss_text": loss_text, "loss_speech": loss_speech}


def init_t3_train_state(params, lr: float = 1e-4, device=None) -> TrainState:
    """A T3 tree copied onto `device` (None: the card) as trainable fp32
    leaves, a fresh AdamW and step 0."""
    params = _trainable(params, device)
    return TrainState(params, _adamw(params, lr), 0)


def _check_t3_step(state, batch, *, mesh, **_) -> None:
    _check_state(state, np.shape(batch["text_tokens"])[0], mesh)


@on_mesh(check=_check_t3_step)
def _t3_step(state: TrainState, batch, *, cfg: T3Config, lr: float, dtype, remat: bool,
             mesh=None):
    device = _leaves(state.params)[0].device
    b = _on(batch, T3_BATCH_KEYS, device)
    loss, metrics = _apply(state, lr, lambda: t3_loss_fn(state.params, b, cfg, dtype, remat,
                                                         mesh), mesh)
    metrics.update(loss=loss, step=torch.tensor(state.step, device=device))
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_t3_train_step(mesh=None, cfg: T3Config = T3Config(), lr: float = 1e-4,
                       dtype=torch.float32, remat: bool = True):
    """Returns step(state, batch) -> (state, metrics): one AdamW update on a
    batch of T3_BATCH_KEYS arrays (moved to the parameters' device).
    metrics: loss, loss_text, loss_speech and the step it was, as device
    tensors. mesh: a dp x tp mesh the state was placed on (shard_t3_state);
    the step then runs on every rank (module docstring). A backbone that
    does not train here raises (models/backbone.py)."""
    backbone.check(cfg.llama, training=True)
    _train_mesh(mesh)
    return functools.partial(_t3_step, cfg=cfg, lr=lr, dtype=dtype, remat=remat, mesh=mesh)


def shard_t3_state(state: TrainState, mesh=None, lr: float = 1e-4) -> TrainState:
    """The tree placed over the mesh's tp and dp by `t3_param_spec`
    (Megatron over tp, everything else replicated) with an AdamW made anew
    over each rank's shards, as the JAX package re-initialises its
    optimizer; on one device (mesh None) only the optimizer is made anew,
    with zero moments."""
    _train_mesh(mesh)
    if mesh is None:
        return TrainState(state.params, _adamw(state.params, lr), state.step)
    return _shard_state(state, mesh, t3_param_spec(state.params), lr)


# ---------------------------------------------------------------------------
# CFM (flow decoder) training
# ---------------------------------------------------------------------------

def flow_loss_fn(params, draws, batch: Dict[str, torch.Tensor], cfm_cfg: CFMConfig,
                 dec_cfg: FlowDecoderConfig, dtype, mesh=None):
    """(loss, {"loss_cfm"}) of a batch of FLOW_BATCH_KEYS tensors, with the
    step's draws from `draws` (cfm.compute_loss; on a mesh this rank's
    part)."""
    loss = cfm_mod.compute_loss(params, draws, batch["mel"], batch["mu"], batch["spks"],
                                batch["cond"], batch["mask"], cfm_cfg, dec_cfg, dtype, mesh)
    return loss, {"loss_cfm": loss}


def init_flow_train_state(params, lr: float = 1e-4, device=None) -> TrainState:
    """A flow-decoder tree copied onto `device` (None: the card) as
    trainable fp32 leaves, a fresh AdamW and step 0."""
    params = _trainable(params, device)
    return TrainState(params, _adamw(params, lr), 0)


def shard_flow_state(state: TrainState, mesh=None, lr: float = 1e-4) -> TrainState:
    """The flow tree replicated on every rank of the mesh (`flow_param_spec`)
    with an AdamW made anew over each rank's copy (the JAX package's jit
    replicates the tree itself; processes need it placed); mesh None: only
    the optimizer is made anew."""
    _train_mesh(mesh)
    if mesh is None:
        return TrainState(state.params, _adamw(state.params, lr), state.step)
    return _shard_state(state, mesh, flow_param_spec(state.params), lr)


def _check_flow_step(state, draws, batch, *, mesh, **_) -> None:
    _check_state(state, np.shape(batch["mel"])[0], mesh)


@on_mesh(check=_check_flow_step)
def _flow_step(state: TrainState, draws, batch, *, cfm_cfg: CFMConfig,
               dec_cfg: FlowDecoderConfig, lr: float, dtype, mesh=None):
    device = _leaves(state.params)[0].device
    b = _on(batch, FLOW_BATCH_KEYS, device)
    loss, metrics = _apply(state, lr, lambda: flow_loss_fn(state.params, draws, b, cfm_cfg,
                                                           dec_cfg, dtype, mesh), mesh)
    metrics["loss"] = loss
    return TrainState(state.params, state.opt_state, state.step + 1), metrics


def make_flow_train_step(mesh=None, cfm_cfg: CFMConfig = CFMConfig(),
                         dec_cfg: FlowDecoderConfig = FlowDecoderConfig(),
                         lr: float = 1e-4, dtype=torch.float32):
    """Returns step(state, draws, batch) -> (state, metrics): one AdamW
    update on a batch of FLOW_BATCH_KEYS arrays (moved to the parameters'
    device); `draws` gives the step's time, noise and CFG keep draws for
    the whole batch. metrics: loss and loss_cfm, device tensors. mesh: a
    dp x tp mesh the state was placed on (shard_flow_state); `draws` must
    then pickle (each rank draws from its copy)."""
    _train_mesh(mesh)
    return functools.partial(_flow_step, cfm_cfg=cfm_cfg, dec_cfg=dec_cfg, lr=lr, dtype=dtype,
                             mesh=mesh)
