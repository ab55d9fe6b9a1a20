"""Serving on a mesh: the PyTorch counterpart of
`chatterbox_embed_tpu/parallel/serve.py`.

Utterance rows (the CFG rows [cond; uncond]) split over `dp`; T3's
backbone takes the Megatron layout over `tp` (each rank streams 1/tp of the
backbone's weights a step, and the two row-parallel products of a layer are
summed over tp). Each rank is a process (parallel/mesh.py): the rows and
the shards are that process's tensors, and `models/t3.py` gathers the
rows' logits over dp once a step, where the JAX package lets GSPMD place
them.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .mesh import (Mesh, P, _tree_map, make_mesh, shard_params, t3_param_spec,
                   visible_devices)
# the JAX package's serve._rows_axis lives beside Mesh.rows, which applies it
from .mesh import _rows_axis  # noqa: F401


def make_dp_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """Rows over n ranks (`mesh.visible_devices`: the first n cards, or n
    ranks on `device`)."""
    return Mesh(np.asarray(visible_devices(n_devices, device), dtype=object), ("dp",))


def make_tp_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """T3's backbone over n ranks for one utterance's latency: q/k/v/gate/up
    split by columns, o/down by rows, two sums over tp a layer. tp must
    divide num_heads (16): 2, 4, 8 or 16."""
    return Mesh(np.asarray(visible_devices(n_devices, device), dtype=object), ("tp",))


def make_dp_tp_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
                    device=None) -> Mesh:
    """The serving mesh: rows over dp, the backbone's Megatron layout over
    tp (default as mesh.make_mesh)."""
    return make_mesh(n_devices, tp=tp, device=device)


def shard_t3_for_decode(mesh: Mesh, t3_params):
    """T3 on a tp (or dp x tp) mesh: Megatron layout on the backbone,
    everything else replicated (mesh.t3_param_spec)."""
    return shard_params(t3_params, t3_param_spec(t3_params), mesh)


def shard_t3_for_serving(mesh: Mesh, t3_params):
    """Megatron over tp when the mesh has a tp axis wider than 1, plain
    replication otherwise (dp-only meshes)."""
    if mesh.tp > 1:
        return shard_t3_for_decode(mesh, t3_params)
    return replicate(mesh, t3_params)


def shard_generation_inputs(mesh: Mesh, context, key_valid=None):
    """This rank's rows of the [cond rows; uncond rows] context (B, P, D)
    and of key_valid (B, L) (B must divide dp); all of them on a tp-only
    mesh."""
    r0, r1 = mesh.rows(context.shape[0])
    return context[r0:r1], None if key_valid is None else key_valid[r0:r1]


def replicate(mesh: Mesh, tree):
    """A copy of the tree on every rank."""
    return shard_params(tree, _tree_map(lambda _: P(), tree), mesh)
