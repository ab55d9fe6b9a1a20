"""Pipeline-parallel T3 training: the PyTorch counterpart of
`chatterbox_embed_tpu/parallel/pipeline.py`, a GPipe schedule of
microbatches over a `pp` line of ranks, each a process (parallel/mesh.py).

Layout, as in the JAX package:
- `stack_t3_for_pipeline` splits the T3 tree into {"stages": every
  per-layer weight stacked to (S, K, ...), "aux": everything else}; each
  rank holds its (1, K, ...) slice of the stages (`shard_pp_params`, spec
  P("pp") on axis 0) and the whole aux (embeddings, conditioning, final
  norm, heads).
- The forward has M + S - 1 ticks: at tick t stage s runs its K layers on
  microbatch t - s (bubble ticks run nothing), then every stage hands its
  output one stage down (`Mesh.shift`). Stage 0 takes the front end's
  embeddings; the last stage keeps each microbatch's output and runs the
  final norm, the heads and the loss over all of them, so the loss divides
  by the whole batch's count (`t3.masked_ce`).

The backward is explicit, where the JAX package transposes its ppermute
through jax.grad: it runs the ticks in reverse, stage s back-propagating
microbatch t - s from the gradient of its output (from the loss on the last
stage, else from the stage below), then every stage hands the gradient of
its input one stage up. A hop as an autograd Function would leave each
rank's backward to meet the collectives in the order its own graph
reaches them, and skip them where a hop's output is unused there (stage
0's received buffer): its neighbours would wait. Explicit ticks put every
hop, forward and back, in one order on every rank. The front end's
gradient leaves stage 0 by one backward through it at the end. The aux
leaves' gradients are summed over pp (the front end's from stage 0, the
head's from the last), so every rank applies the same AdamW update to its
copy of aux; each stage updates its own layers.

The layers are `llama._layer`, the training forward's (plain attention
under the causal key-valid mask, no remat), and the context and heads are
t3.forward's, so the loss equals one process's t3.loss.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from ..config import T3Config
from ..models import llama as llama_mod
from ..models import layers as L
from ..models import t3 as t3_mod
from ..training.train_step import T3_BATCH_KEYS, _adamw, _leaves
from .mesh import (Mesh, P, ShardTree, _tree_map, kept, on_mesh, shard_params,
                   visible_devices)


def make_pp_mesh(n_stages: int, device=None) -> Mesh:
    """A line of n_stages ranks named pp (`mesh.visible_devices`: the first
    n cards, or n ranks on `device`)."""
    devices = visible_devices(n_stages, device)
    if len(devices) != n_stages:
        raise ValueError(f"a pipeline of {n_stages} stages needs {n_stages} devices")
    return Mesh(np.asarray(devices, dtype=object), ("pp",))


# ---------------------------------------------------------------------------
# parameter restructuring
# ---------------------------------------------------------------------------

def stack_t3_for_pipeline(t3_params, n_stages: int):
    """{"stages", "aux"}: every per-layer Llama weight stacked to
    (S, K, ...) (S = n_stages, K layers a stage); the embeddings, the
    conditioning encoder, the heads and the final norm ("llama_norm") in
    aux. The layers must split evenly into the stages."""
    layers = t3_params["llama"]["layers"]
    if len(layers) % n_stages:
        raise ValueError(f"{len(layers)} layers do not split into {n_stages} stages")
    k = len(layers) // n_stages
    stacked = _tree_map(lambda *xs: torch.stack(xs).reshape((n_stages, k) + tuple(xs[0].shape)),
                        layers[0], *layers[1:])
    aux = {kk: v for kk, v in t3_params.items() if kk != "llama"}
    aux["llama_norm"] = t3_params["llama"]["norm"]
    return {"stages": stacked, "aux": aux}


def unstack_t3_from_pipeline(pp_params, cfg: T3Config = T3Config()):
    """The inverse of stack_t3_for_pipeline (checkpoint interchange): the
    whole tree, from a tree whose stages hold every stage."""
    stacked = pp_params["stages"]
    s, k = _leaves(stacked)[0].shape[:2]
    layers = [_tree_map(lambda x: x[i // k, i % k], stacked) for i in range(s * k)]
    out = {kk: v for kk, v in pp_params["aux"].items() if kk != "llama_norm"}
    out["llama"] = {"layers": layers, "norm": pp_params["aux"]["llama_norm"]}
    return out


def pp_param_spec(pp_params) -> dict:
    """The stages split over pp on their first axis; aux replicates."""
    return {"stages": _tree_map(lambda _: P("pp"), pp_params["stages"]),
            "aux": _tree_map(lambda _: P(), pp_params["aux"])}


def shard_pp_params(pp_params, mesh: Mesh):
    """Each rank's (1, K, ...) stage slice and a copy of aux (broadcast
    from the leader), kept on the mesh."""
    return shard_params(pp_params, pp_param_spec(pp_params), mesh)


# ---------------------------------------------------------------------------
# stage compute and the two ends
# ---------------------------------------------------------------------------

def _apply_stage(stage_params, x, cos, sin, mask4, cfg: T3Config, dtype):
    """This stage's K layers ((1, K, ...) leaves) on x, in order: the
    training forward's layer (llama._layer)."""
    h = x.to(dtype)
    k = _leaves(stage_params)[0].shape[1]
    for i in range(k):
        lp = _tree_map(lambda a: a[0, i], stage_params)
        h = llama_mod._layer(lp, h, cos, sin, mask4, cfg.llama, dtype)
    return h


def _context_and_mask(aux, batch, cfg: T3Config):
    """The front end of t3.forward on the whole batch: ([cond; text;
    speech] embeddings, rope cos and sin, the (B, 1, T, T) mask, widths)."""
    cond = t3_mod.T3Cond(speaker_emb=batch["speaker_emb"],
                         cond_prompt_speech_tokens=batch["cond_prompt_tokens"],
                         emotion_adv=batch["emotion_adv"])
    x, pos, mask, widths = t3_mod._train_context(
        aux, cond, batch["text_tokens"], batch["text_lens"], batch["speech_tokens"],
        batch["speech_lens"], cfg)
    cos, sin = llama_mod.rope_cos_sin(pos, cfg.llama)
    return x, cos, sin, mask[:, None], widths


def _head_loss(aux, h, batch, widths, cfg: T3Config, dtype):
    """The final norm, the two heads and loss_text + loss_speech over the
    whole batch's hidden states h (t3.loss's)."""
    h = L.rms_norm(aux["llama_norm"], h, cfg.llama.rms_norm_eps)
    text_logits, speech_logits = t3_mod._train_heads(aux, h, widths, dtype)
    return (t3_mod.masked_ce(text_logits, batch["text_tokens"], batch["text_lens"])
            + t3_mod.masked_ce(speech_logits, batch["speech_tokens"], batch["speech_lens"]))


# ---------------------------------------------------------------------------
# the pipelined loss
# ---------------------------------------------------------------------------

def pp_loss(pp_params, batch: Dict[str, torch.Tensor], n_stages: int, n_micro: int,
            cfg: T3Config = T3Config(), dtype=torch.float32, *, mesh: Mesh,
            backward: bool = False) -> torch.Tensor:
    """The pipelined T3 loss, run on every rank of the pp mesh (inside a
    mesh call) with this rank's pp_params and the whole batch; microbatches
    split axis 0. Returns the loss, the same on every stage. `backward`:
    also run the pipelined backward, which leaves in every leaf's .grad
    what one process's loss.backward() would (the stages' own; aux summed
    over pp). The module docstring gives the schedule."""
    if mesh.pp != n_stages:
        raise ValueError(f"{n_stages} stages on a pp mesh of {mesh.pp}")
    b = batch["text_tokens"].shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    s, last = mesh.pp_index, n_stages - 1
    stages, aux = pp_params["stages"], pp_params["aux"]
    mb = b // n_micro
    n_ticks = n_micro + n_stages - 1
    x, cos, sin, mask4, widths = _context_and_mask(aux, batch, cfg)
    shape = (mb,) + tuple(x.shape[1:])
    dev = x.device
    first_in = x.detach().requires_grad_(backward)
    micro = lambda a, i: a[i * mb:(i + 1) * mb]       # noqa: E731
    ins, outs = [None] * n_micro, [None] * n_micro
    buf = None
    with contextlib.nullcontext() if backward else torch.no_grad():
        for t in range(n_ticks):
            i = t - s
            send = torch.zeros(shape, dtype=dtype, device=dev)
            if 0 <= i < n_micro:
                ins[i] = (micro(first_in, i) if s == 0
                          else buf.detach().requires_grad_(backward))
                outs[i] = _apply_stage(stages, ins[i], micro(cos, i), micro(sin, i),
                                       micro(mask4, i), cfg, dtype)
                send = outs[i].detach()
            if t < n_ticks - 1:
                buf = mesh.shift(send, "pp", 1)
        loss = torch.zeros((), device=dev)
        if s == last:
            hs = [y.detach().requires_grad_(backward) for y in outs]
            loss = _head_loss(aux, torch.cat(hs).float(), batch, widths, cfg, dtype)
    if backward:
        if s == last:
            loss.backward()
        grad = None
        for t in reversed(range(n_ticks)):
            i = t - s
            send = torch.zeros(shape, dtype=dtype, device=dev)
            if 0 <= i < n_micro:
                torch.autograd.backward(outs[i], hs[i].grad if s == last else grad)
                if s > 0:
                    send = ins[i].grad
            if t > 0:
                grad = mesh.shift(send, "pp", -1)
        if s == 0:
            x.backward(first_in.grad)
        mesh.sum_grads(_leaves(aux), "pp")
    return mesh.sum(loss.detach().clone(), "pp")


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

class PPTrainState(NamedTuple):
    params: Any                  # each rank's pp tree of fp32 leaves that require grad
    opt_state: Any               # each rank's AdamW over them
    step: int


def _trainable(tree):
    """A rank's pp tree as fresh fp32 leaves that require grad, kept."""
    return ShardTree(_tree_map(
        lambda x: x.detach().to(torch.float32).clone().requires_grad_(True), dict(tree)))


def _check_step(state, batch, *, mesh, n_micro, **_):
    b = np.shape(batch["text_tokens"])[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not split into {n_micro} microbatches")
    if mesh.leads() and not kept(state.params):
        raise ValueError("the state's params are not on the mesh: make the state with the "
                         "init_state of make_pp_train_step")


@on_mesh(check=_check_step)
def _pp_step(state: PPTrainState, batch, *, n_micro: int, cfg: T3Config, lr: float, dtype,
             mesh: Mesh):
    params, opt = state.params, state.opt_state
    device = _leaves(params)[0].device
    b = {k: torch.as_tensor(batch[k], device=device) for k in T3_BATCH_KEYS}
    for group in opt.param_groups:
        group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    loss = pp_loss(params, b, mesh.pp, n_micro, cfg, dtype, mesh=mesh, backward=True)
    opt.step()
    return PPTrainState(params, opt, state.step + 1), {"loss": loss}


def _init_state(pp_params, *, mesh: Mesh, lr: float) -> PPTrainState:
    if not kept(pp_params):
        raise ValueError("pp_params are not on the mesh: shard_pp_params(stack_t3_for_"
                         "pipeline(params, n_stages), mesh) first")
    params = mesh.make(_trainable, pp_params)
    return PPTrainState(params, mesh.make(_adamw, params, lr), 0)


def make_pp_train_step(mesh: Mesh, n_micro: int, cfg: T3Config = T3Config(),
                       lr: float = 1e-4, dtype=torch.float32):
    """Returns (step, init_state): init_state(pp_params) makes each rank's
    trainable copy of its shard_pp_params tree and its AdamW (optax.adamw's
    defaults, weight decay 0.01); step(state, batch) runs one pipelined
    AdamW step on every rank of the pp mesh, called on the leader with the
    whole batch (numpy arrays or tensors; the pipeline parallelises layers,
    not rows), and returns (state, {"loss"}) there."""
    if not isinstance(mesh, Mesh) or mesh.axis_names != ("pp",):
        raise ValueError("make_pp_train_step runs on a pp mesh (make_pp_mesh)")
    step = functools.partial(_pp_step, n_micro=n_micro, cfg=cfg, lr=lr, dtype=dtype, mesh=mesh)
    return step, functools.partial(_init_state, mesh=mesh, lr=lr)
