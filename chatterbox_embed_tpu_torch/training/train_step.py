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
- One device: `mesh` takes None only (the JAX package's steps shard over a
  dp x tp mesh; the port serves on a mesh, parallel/, and trains on one
  in ROADMAP item 21b), and the step makers return the step alone, with
  no batch shardings.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from ..config import CFMConfig, FlowDecoderConfig, T3Config
from ..device import resolve_device
from ..models import cfm as cfm_mod
from ..models import t3 as t3_mod

T3_BATCH_KEYS = ("speaker_emb", "cond_prompt_tokens", "emotion_adv", "text_tokens",
                 "text_lens", "speech_tokens", "speech_lens")
FLOW_BATCH_KEYS = ("mel", "mu", "spks", "cond", "mask")


class TrainState(NamedTuple):
    params: Any                  # the port's tree of fp32 leaves that require grad
    opt_state: torch.optim.AdamW  # its moments; a step updates both in place
    step: int


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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("the port trains on one device: mesh must be None "
                         "(training on a mesh is ROADMAP item 21b)")


def _trainable(params, device):
    """A copy of `params` on `device` with fp32 leaves that require grad."""
    device = resolve_device(device)
    return _map(lambda x: torch.as_tensor(x).detach().to(device=device, dtype=torch.float32)
                .clone().requires_grad_(True), params)


def _on(batch: Dict[str, Any], keys, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k], device=device) for k in keys}


def _apply(state: TrainState, lr: float, loss_and_metrics):
    """One AdamW update from the loss that `loss_and_metrics()` computes."""
    opt = state.opt_state
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss, metrics = loss_and_metrics()
    loss.backward()
    opt.step()
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics


# ---------------------------------------------------------------------------
# T3 (speech LM) training
# ---------------------------------------------------------------------------

def t3_loss_fn(params, batch: Dict[str, torch.Tensor], cfg: T3Config, dtype,
               remat: bool = False):
    """(loss_text + loss_speech, {"loss_text", "loss_speech"}) of a batch of
    T3_BATCH_KEYS tensors."""
    cond = t3_mod.T3Cond(speaker_emb=batch["speaker_emb"],
                         cond_prompt_speech_tokens=batch["cond_prompt_tokens"],
                         emotion_adv=batch["emotion_adv"])
    loss_text, loss_speech = t3_mod.loss(
        params, cond, batch["text_tokens"], batch["text_lens"],
        batch["speech_tokens"], batch["speech_lens"], cfg, dtype, remat)
    return loss_text + loss_speech, {"loss_text": loss_text, "loss_speech": loss_speech}


def init_t3_train_state(params, lr: float = 1e-4, device=None) -> TrainState:
    """A T3 tree copied onto `device` (None: the card) as trainable fp32
    leaves, a fresh AdamW and step 0."""
    params = _trainable(params, device)
    return TrainState(params, _adamw(params, lr), 0)


def make_t3_train_step(mesh=None, cfg: T3Config = T3Config(), lr: float = 1e-4,
                       dtype=torch.float32, remat: bool = True):
    """Returns step(state, batch) -> (state, metrics): one AdamW update on a
    batch of T3_BATCH_KEYS arrays (moved to the parameters' device).
    metrics: loss, loss_text, loss_speech and the step it was, as device
    tensors."""
    _no_mesh(mesh)

    def step(state: TrainState, batch):
        device = _leaves(state.params)[0].device
        b = _on(batch, T3_BATCH_KEYS, device)
        loss, metrics = _apply(state, lr, lambda: t3_loss_fn(state.params, b, cfg, dtype,
                                                             remat))
        metrics.update(loss=loss, step=torch.tensor(state.step, device=device))
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step


def shard_t3_state(state: TrainState, mesh=None, lr: float = 1e-4) -> TrainState:
    """The JAX package places the tree over a tp/dp mesh and re-initialises
    the optimizer; on one device (mesh None) only the optimizer is made
    anew, with zero moments."""
    _no_mesh(mesh)
    return TrainState(state.params, _adamw(state.params, lr), state.step)


# ---------------------------------------------------------------------------
# CFM (flow decoder) training
# ---------------------------------------------------------------------------

def flow_loss_fn(params, draws, batch: Dict[str, torch.Tensor], cfm_cfg: CFMConfig,
                 dec_cfg: FlowDecoderConfig, dtype):
    """(loss, {"loss_cfm"}) of a batch of FLOW_BATCH_KEYS tensors, with the
    step's draws from `draws` (cfm.compute_loss)."""
    loss = cfm_mod.compute_loss(params, draws, batch["mel"], batch["mu"], batch["spks"],
                                batch["cond"], batch["mask"], cfm_cfg, dec_cfg, dtype)
    return loss, {"loss_cfm": loss}


def init_flow_train_state(params, lr: float = 1e-4, device=None) -> TrainState:
    """A flow-decoder tree copied onto `device` (None: the card) as
    trainable fp32 leaves, a fresh AdamW and step 0."""
    params = _trainable(params, device)
    return TrainState(params, _adamw(params, lr), 0)


def make_flow_train_step(mesh=None, cfm_cfg: CFMConfig = CFMConfig(),
                         dec_cfg: FlowDecoderConfig = FlowDecoderConfig(),
                         lr: float = 1e-4, dtype=torch.float32):
    """Returns step(state, draws, batch) -> (state, metrics): one AdamW
    update on a batch of FLOW_BATCH_KEYS arrays (moved to the parameters'
    device); `draws` gives the step's time, noise and CFG keep draws.
    metrics: loss and loss_cfm, device tensors."""
    _no_mesh(mesh)

    def step(state: TrainState, draws, batch):
        device = _leaves(state.params)[0].device
        b = _on(batch, FLOW_BATCH_KEYS, device)
        loss, metrics = _apply(state, lr, lambda: flow_loss_fn(state.params, draws, b,
                                                               cfm_cfg, dec_cfg, dtype))
        metrics["loss"] = loss
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step
