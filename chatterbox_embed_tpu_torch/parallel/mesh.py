"""Device mesh and sharding rules over torch.distributed, the PyTorch
counterpart of `chatterbox_embed_tpu/parallel/mesh.py`.

The JAX package is one controller over many chips: GSPMD partitions one
program over a `jax.sharding.Mesh`. Here every rank of a mesh is a process
of its own, and the collectives are written out:

- The process that builds the mesh is rank 0, the leader. It holds the
  pipeline, runs S3Gen and everything else, and takes part in T3 as one
  rank. The other ranks are followers, started with the `spawn` method when
  the first mesh over their devices is built. They run T3 only.
- A call on the mesh (`Mesh.call`): the leader sends the function and its
  arguments to every follower over a pipe, then runs the function itself.
  Each rank runs it on its own shard, and the ranks meet in the collectives
  inside it: the tp sums of the row-parallel products, the dp gathers of
  rows. A function wrapped by `on_mesh` and called on the leader with
  `mesh=` runs this way; so does a method wrapped by `on_mesh_method` of an
  object whose `mesh` is set.
- An object that lives on every rank (a tree of weight shards, an engine)
  is kept per rank under one key (`Mesh.make`, `Mesh.adopt`). In a call's
  arguments it travels as its key, and each rank finds its own part. When
  the leader's part is collected, the followers drop theirs with the next
  call. A mesh is kept the same way, once per shape a world: building a
  mesh of that shape again reuses its key and its process groups. Other
  tensors travel by value, through host memory: one that the leader holds
  on a card lands on the receiving rank's device, and a CUDA `torch.device`
  becomes the receiving rank's.
- The backend follows the layout: NCCL for device tensors when every rank
  has a card of its own, gloo when ranks share a device (the CPU, or two
  ranks on one card, which NCCL refuses); host tensors always go over
  gloo. The choice is printed on one line. Rendezvous is a file in a
  temporary directory, so that two worlds on one host never meet. Nothing
  falls back to another backend or device.
- A follower computes as the leader does: each call carries the leader's
  TF32 switches (`torch.backends.cuda.matmul.allow_tf32`,
  `torch.backends.cudnn.allow_tf32`), which a spawned process would
  otherwise take at torch's defaults (cuDNN's on: TF32 convolutions on a
  card), and its CHATTERBOX_* settings, which the models read at call time
  (CHATTERBOX_INT8_KV picks each rank's cache, CHATTERBOX_DEFER_KV its
  decode step): a follower spawned earlier would otherwise keep the
  environment it started with.
- A follower that fails sends its traceback to the leader and exits, so a
  collective waiting on it fails on the other ranks; the world is then
  closed, and the next mesh starts a new one. `shutdown` (also run at
  exit) stops every follower and joins it.

The spec of a parameter is a `PartitionSpec`, one mesh axis (or None) per
dimension, as in the JAX package: the Megatron layout of T3's backbone
splits q/k/v/gate/up along their output features and o/down along their
input features; everything else replicates.

A mesh is a (dp, tp) grid (serving and the train steps) or one line of
ranks named `sp` (sequence parallel mel generation, parallel/sp.py) or `pp`
(pipeline-parallel T3 training, parallel/pipeline.py), as the JAX package
builds its `("sp",)` and `("pp",)` meshes.

Training adds collectives that autograd sees (Megatron's pair, `tp_input`
and `sum_tp` under autograd) and two that run outside the graph in a fixed
order on every rank: the sum of gradients over an axis (`sum_grads`, one
all-reduce of the gradients laid end to end) and the hop of the pipeline
and of the sequence halo (`shift`). A hop is one `all_gather` over the
axis on every backend, each rank keeping its neighbour's part: gloo's
point-to-point of CUDA tensors is untried (torch 2.11+cu128), and NCCL's
needs a card a rank, which one card cannot test. The backend line says so.
"""
from __future__ import annotations

import atexit
import functools
import io
import itertools
import multiprocessing
import os
import pickle
import shutil
import tempfile
import traceback
import weakref
from datetime import timedelta
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails (a follower that hangs)
TIMEOUT = timedelta(minutes=10)
# seconds a follower may take to start (import torch and the port)
START_S = 300
# the 1-D meshes: sequence parallel mel generation and the T3 pipeline
LINE_AXES = ("sp", "pp")
# how a hop along sp or pp moves, the same on every backend (module docstring)
HOP = "all_gather"
# the largest piece of a message on a pipe (`_send`)
PIECE = 1 << 20


class MeshAxes(NamedTuple):
    dp: str = "dp"
    tp: str = "tp"


class PartitionSpec(tuple):
    """One mesh axis name (or None) per dimension of a parameter; () or
    all-None replicates it (jax.sharding.PartitionSpec)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __reduce__(self):
        return PartitionSpec, tuple(self)

    def __repr__(self):
        return f"P{tuple(self)}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# this process's part: the world (the leader) or its rank (a follower), and
# the objects kept under keys
# ---------------------------------------------------------------------------

# Process-wide, as torch.distributed's default process group is: a process
# is in one world at a time, as the leader or as one follower.
_WORLD = None            # the leader's _World
_FOLLOWER = None         # a follower's (rank, device)
_OBJECTS: dict = {}      # a follower: key -> object this rank keeps
_KEY_OF: dict = {}       # the leader: id(object) -> key, while the object lives
_INSIDE = [False]        # the leader is running a mesh call


def _lookup(key):
    return _OBJECTS[key]


def _rank_device():
    return _FOLLOWER[1]


def _tensor(raw: bytes, dtype, shape, on_card: bool):
    if not raw:
        t = torch.empty(shape, dtype=dtype)
    else:
        t = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dtype).reshape(shape)
    return t.to(_rank_device()) if on_card else t


def _tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous().reshape(-1)
    return t.view(torch.uint8).numpy().tobytes() if t.numel() else b""


class _CallPickler(pickle.Pickler):
    """A call's arguments: kept objects as their key, tensors by value
    (compact; from a card to the receiving rank's device), CUDA devices
    as the receiving rank's."""

    def reducer_override(self, obj):
        key = _KEY_OF.get(id(obj))
        if key is not None:
            return _lookup, (key,)
        if isinstance(obj, torch.Tensor):
            return _tensor, (_tensor_bytes(obj), obj.dtype, tuple(obj.shape),
                             obj.device.type != "cpu")
        if isinstance(obj, torch.device) and obj.type != "cpu":
            return _rank_device, ()
        return NotImplemented


class _ReplyPickler(pickle.Pickler):
    """A follower's result: tensors by value, on the host."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _tensor, (_tensor_bytes(obj), obj.dtype, tuple(obj.shape), False)
        return NotImplemented


def _tf32() -> tuple:
    """This process's TF32 switches (matmuls, cuDNN)."""
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _set_tf32(switches) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = switches


def _settings() -> dict:
    """This process's CHATTERBOX_* environment."""
    return {k: v for k, v in os.environ.items() if k.startswith("CHATTERBOX_")}


def _set_settings(settings: dict) -> None:
    """Make this process's CHATTERBOX_* environment the leader's."""
    for k in [k for k in os.environ if k.startswith("CHATTERBOX_") and k not in settings]:
        del os.environ[k]
    os.environ.update(settings)


def _send(conn, data: bytes) -> None:
    """One message on a pipe, as its count of pieces and pieces of at most
    PIECE bytes: CPython's Connection reads a message with os.read(fd,
    bytes still to come), allocating that much for each read of the pipe's
    few kilobytes, so one message of a gigabyte took minutes (measured on
    an H100 host)."""
    view = memoryview(data)
    pieces = [view[i:i + PIECE] for i in range(0, len(view), PIECE)]
    conn.send_bytes(len(pieces).to_bytes(8, "little"))
    for piece in pieces:
        conn.send_bytes(piece)


def _recv(conn) -> bytes:
    """A message that `_send` sent."""
    n = int.from_bytes(conn.recv_bytes(), "little")
    return b"".join(conn.recv_bytes() for _ in range(n))


def _dumps(obj, pickler=_CallPickler) -> bytes:
    buf = io.BytesIO()
    pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the world: the processes of the meshes built over one list of devices
# ---------------------------------------------------------------------------

def _backend(devices) -> tuple:
    """(backend, reason) for ranks on `devices` (one each)."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo", "every rank on the CPU"
    if kinds != {"cuda"}:
        raise ValueError(f"a mesh's ranks run all on the CPU or all on cards: {devices}")
    if len(set(devices)) == len(devices):
        return "cpu:gloo,cuda:nccl", "every rank has a card of its own"
    return "cpu:gloo,cuda:gloo", "ranks share a card, which NCCL refuses"


def _join(rank: int, devices, init: str, backend: str) -> None:
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init, world_size=len(devices), rank=rank,
                            timeout=TIMEOUT)
    # every rank's device backend answers before the world serves
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    if int(probe.item()) != len(devices):
        raise RuntimeError(f"world check: all_reduce gave {probe.item()}, want {len(devices)}")


def _follow(rank: int, devices, init: str, backend: str, conn, threads: int) -> None:
    """A follower's life: join the world, then run the leader's calls until
    it says stop, its pipe closes or the leader is gone."""
    global _FOLLOWER
    torch.set_num_threads(threads)
    _FOLLOWER = (rank, torch.device(devices[rank]))
    conn.send_bytes(b"ready")
    _join(rank, devices, init, backend)
    parent = multiprocessing.parent_process()
    while True:
        if not conn.poll(1.0):
            if parent is not None and not parent.is_alive():
                break
            continue
        try:
            raw = _recv(conn)
        except EOFError:
            break
        try:
            msg = pickle.loads(raw)
            if msg[0] == "stop":
                break
            if msg[0] == "release":
                for key in msg[1]:
                    _OBJECTS.pop(key, None)
                continue
            _, keep, fn, args, kwargs, want, tf32, settings = msg
            _set_tf32(tf32)
            _set_settings(settings)
            out = fn(*args, **kwargs)
            if keep is not None:
                _OBJECTS[keep] = out
            _send(conn, _dumps(("ok", out if want else None), _ReplyPickler))
        except BaseException:       # noqa: BLE001 — the leader gets every error
            _send(conn, _dumps(("err", traceback.format_exc()), _ReplyPickler))
            conn.close()
            os._exit(1)             # fail the collectives that wait on this rank
    if dist.is_initialized():
        dist.destroy_process_group()


class _World:
    """The processes of one list of devices: rank 0 is this process, ranks
    1.. are followers; the default process group spans them all."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self.backend, reason = _backend(self.devices)
        self.dir = tempfile.mkdtemp(prefix="cbx-mesh-")
        self.procs, self.conns = [], []
        self.keys = itertools.count(1)
        self.meshes: dict = {}           # (axis names, shape) -> (key, the leader's groups)
        self.pending: dict = {}          # follower rank -> keys to release
        self.closed = None               # why the world closed
        init = "file://" + os.path.join(self.dir, "rendezvous")
        names = [str(d) for d in self.devices]
        ctx = multiprocessing.get_context("spawn")
        try:
            for r in range(1, len(names)):
                ours, theirs = ctx.Pipe()
                proc = ctx.Process(target=_follow, name=f"cbx-mesh-rank{r}", daemon=True,
                                   args=(r, names, init, self.backend, theirs,
                                         torch.get_num_threads()))
                proc.start()
                theirs.close()
                self.procs.append(proc)
                self.conns.append(ours)
                self.pending[r] = []
            for r, (proc, conn) in enumerate(zip(self.procs, self.conns), 1):
                if not conn.poll(START_S) or conn.recv_bytes() != b"ready":
                    raise RuntimeError(f"mesh rank {r} did not start (exit code "
                                       f"{proc.exitcode})")
            _join(0, names, init, self.backend)
        except BaseException:
            self.close("it failed to start", failed=True)
            raise
        print(f"[mesh] world of {len(names)} rank(s) on {','.join(names)}: backend "
              f"{self.backend} ({reason}); sp and pp hops by {HOP}", flush=True)

    @property
    def size(self) -> int:
        return len(self.devices)

    def run(self, ranks, fn, args, kwargs, keep=None, local=None, want=False):
        """Run fn(*args, **kwargs) on the followers among `ranks` and
        `local()` (default the same call) here; returns (this rank's result,
        the followers' results when `want`). `keep`: each rank keeps its
        result under that key. Any rank's failure closes the world and
        raises."""
        if self.closed:
            raise RuntimeError(f"the mesh's world is closed ({self.closed}); build a new mesh")
        conns = [(r, self.conns[r - 1]) for r in ranks if r > 0]
        payload = _dumps(("call", keep, fn, args, kwargs, want, _tf32(), _settings()))
        for r, conn in conns:
            release, self.pending[r] = self.pending[r], []
            if release:
                _send(conn, pickle.dumps(("release", release)))
            _send(conn, payload)
        _INSIDE[0] = True
        try:
            out = local() if local is not None else fn(*args, **kwargs)
        except BaseException as e:
            errors = self._replies(conns, wait=2.0)[1]
            self.close(f"rank 0 failed: {e!r}", failed=True)
            if errors:
                raise RuntimeError("a mesh call failed:\n" + "\n".join(errors)) from e
            raise
        finally:
            _INSIDE[0] = False
        results, errors = self._replies(conns)
        if errors:
            self.close("a follower failed", failed=True)
            raise RuntimeError("a mesh call failed on a follower:\n" + "\n".join(errors))
        return out, results

    def pending_release(self, key, ranks) -> None:
        """The followers among `ranks` drop `key` before their next call."""
        if not self.closed:
            for r in ranks:
                self.pending[r].append(key)

    def _replies(self, conns, wait: Optional[float] = None):
        results, errors = [], []
        for r, conn in conns:
            try:
                if wait is not None and not conn.poll(wait):
                    continue
                status, value = pickle.loads(_recv(conn))
            except (EOFError, OSError) as e:
                status, value = "err", f"the process is gone ({e!r})"
            if status == "err":
                errors.append(f"--- mesh rank {r}:\n{value}")
            results.append(value)
        return results, errors

    def close(self, why: str = "shut down", failed: bool = False) -> None:
        """Stop the followers and join them. After a failure the process
        group goes first, so that a follower waiting in a collective fails
        out of it instead of being waited for."""
        if self.closed:
            return
        self.closed = why
        for conn in self.conns:
            try:
                _send(conn, pickle.dumps(("stop",)))
            except (OSError, ValueError):
                pass
        if failed and dist.is_initialized():
            dist.destroy_process_group()
        for proc in self.procs:
            proc.join(timeout=5 if failed else 30)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=5)
        for conn in self.conns:
            conn.close()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.dir, ignore_errors=True)
        _OBJECTS.clear()
        _KEY_OF.clear()


def _world_for(devices) -> _World:
    """The world whose first ranks run on `devices`: the current one when
    it fits, else a new one (the current one is shut down first)."""
    global _WORLD
    if _FOLLOWER is not None:
        raise RuntimeError("a mesh is built by the leader, not by a follower")
    devices = tuple(devices)
    if (_WORLD is not None and not _WORLD.closed
            and _WORLD.devices[:len(devices)] == devices):
        return _WORLD
    shutdown()
    _WORLD = _World(devices)
    return _WORLD


def shutdown() -> None:
    """Stop every follower of this process's world and join it (at exit
    too). Meshes built before it are closed; the next one starts anew."""
    global _WORLD
    if _WORLD is not None:
        _WORLD.close()
        _WORLD = None


atexit.register(shutdown)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

def _groups(key, axis_names, shape, names):
    """On every rank of the world: the mesh's process groups (new_group is
    collective over the world, in one order everywhere), made once per
    shape a world; a follower that is a member keeps its view of the mesh
    under `key`. Returns this rank's (group, dp_group, tp_group); a line
    mesh's sp or pp group is its whole group."""
    n = len(names)
    dp, tp = shape.get("dp", 1), shape.get("tp", 1)
    rank = dist.get_rank()
    whole = dist.new_group(list(range(n))) if n > 1 else None
    dp_groups = ([dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
                 if dp > 1 else [None] * tp)
    tp_groups = ([dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
                 if tp > 1 else [None] * dp)
    if rank >= n:
        return None
    line = axis_names[0] in LINE_AXES
    mine = (whole, None, None) if line else (whole, dp_groups[rank % tp], tp_groups[rank // tp])
    if _FOLLOWER is not None:
        mesh = Mesh.__new__(Mesh)
        mesh._setup(key, axis_names, shape, names, rank, *mine)
        _OBJECTS[key] = mesh
    return mine


class Mesh:
    """A (dp, tp) grid of ranks, each a process on one device (the
    counterpart of jax.sharding.Mesh): `devices` is an array of devices (or
    their names) of shape (dp, tp), or (n,) under one axis name: dp, tp, or
    one of LINE_AXES (sp, pp). Rank r runs on the r-th device in row-major
    order; rank 0 is the process that builds the mesh, the leader. A device
    named twice hosts two ranks (the CPU tests; two ranks on one card).

    `shape` maps each axis name to its size, as in the JAX package; `dp`,
    `tp`, `sp` and `pp` are 1 for an absent axis. On each rank: `rank`,
    `device`, `dp_index`, `tp_index`, `sp_index`, `pp_index`, and the
    process groups `group` (the whole mesh), `dp_group` (the ranks of this
    tp index), `tp_group` (the ranks of this dp index), `sp_group` and
    `pp_group` (a line mesh's whole group), each None where it would hold
    one rank or the axis is absent. Meshes of one shape in one world share
    their key and their groups."""

    def __init__(self, devices, axis_names=("dp", "tp")):
        grid = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        grid_axes = len(set(axis_names)) == len(axis_names) and set(axis_names) <= set(MeshAxes())
        line = len(axis_names) == 1 and axis_names[0] in LINE_AXES
        if grid.ndim != len(axis_names) or not (grid_axes or line):
            raise ValueError(f"mesh of shape {grid.shape} with axes {axis_names}: one axis "
                             f"name of {tuple(MeshAxes())} per dimension, or one line "
                             f"axis of {LINE_AXES}")
        names = [str(torch.device(d)) for d in grid.reshape(-1)]
        world = _world_for([torch.device(n) for n in names])
        shape = dict(zip(axis_names, grid.shape))
        known = world.meshes.get((axis_names, grid.shape))
        if known is None:
            key = next(world.keys)
            groups, _ = world.run(range(world.size), _groups, (key, axis_names, shape, names), {})
            known = world.meshes[axis_names, grid.shape] = (key, groups)
        self._setup(known[0], axis_names, shape, names, 0, *known[1])
        self._world = world

    def _setup(self, key, axis_names, shape, names, rank, group, dp_group, tp_group):
        self.key, self.axis_names, self.shape = key, axis_names, dict(shape)
        self.names = tuple(names)
        self.devices = np.asarray([torch.device(n) for n in names],
                                  dtype=object).reshape(tuple(shape.values()))
        self.rank = rank
        self.device = torch.device(names[rank])
        line = axis_names[0] if axis_names[0] in LINE_AXES else None
        self.dp_index, self.tp_index = divmod(rank, self.tp) if line is None else (0, 0)
        self.sp_index, self.pp_index = (rank if line == "sp" else 0), (rank if line == "pp" else 0)
        self.group, self.dp_group, self.tp_group = group, dp_group, tp_group
        self.sp_group = group if line == "sp" else None
        self.pp_group = group if line == "pp" else None
        self._world = None

    def __reduce__(self):
        return _lookup, (self.key,)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} on {self.device})"

    @property
    def dp(self) -> int:
        return self.shape.get("dp", 1)

    @property
    def tp(self) -> int:
        return self.shape.get("tp", 1)

    @property
    def sp(self) -> int:
        return self.shape.get("sp", 1)

    @property
    def pp(self) -> int:
        return self.shape.get("pp", 1)

    @property
    def size(self) -> int:
        return len(self.names)

    def axis(self, name: str) -> tuple:
        """(size, this rank's index, process group) of axis `name`."""
        return {"dp": (self.dp, self.dp_index, self.dp_group),
                "tp": (self.tp, self.tp_index, self.tp_group),
                "sp": (self.sp, self.sp_index, self.sp_group),
                "pp": (self.pp, self.pp_index, self.pp_group)}[name]

    # -- calls ------------------------------------------------------------

    def leads(self) -> bool:
        """True on the leader outside a mesh call: a call made here is sent
        to the followers before it runs here."""
        return _FOLLOWER is None and not _INSIDE[0]

    def _run(self, fn, args, kwargs, keep=None, local=None, want=False):
        if self._world is None or not self.leads():
            raise RuntimeError("mesh calls are sent by the leader, outside another mesh call")
        return self._world.run(range(self.size), fn, args, kwargs, keep, local, want)

    def call(self, fn, *args, **kwargs):
        """fn(*args, **kwargs) on every rank; returns the leader's result."""
        if not self.leads():
            return fn(*args, **kwargs)
        return self._run(fn, args, kwargs)[0]

    def call_all(self, fn, *args, **kwargs) -> list:
        """fn(*args, **kwargs) on every rank; returns every rank's result
        (tensors on the host for the followers), in rank order."""
        out, rest = self._run(fn, args, kwargs, want=True)
        return [out] + rest

    def make(self, fn, *args, local=None, **kwargs):
        """fn(*args, **kwargs) on every rank (`local()` on the leader, when
        given), each rank keeping its result under one key for later calls;
        returns the leader's. When the caller drops it, the followers drop
        theirs with the next call. The result must not be a plain dict,
        list or tuple, which pickling copies without asking and which
        cannot be referenced weakly (a `ShardTree` is a dict that can)."""
        key = next(self._world.keys)
        out, _ = self._run(fn, args, kwargs, keep=key, local=local)
        if type(out) in (dict, list, tuple):
            self._world.pending_release(key, range(1, self.size))
            raise TypeError(f"a kept object cannot be a plain {type(out).__name__}")
        _KEY_OF[id(out)] = key
        weakref.finalize(out, _forget, self._world, id(out), key, range(1, self.size))
        return out

    def adopt(self, obj, fn, *args, **kwargs) -> None:
        """Make `obj`, built here, the leader's part of an object whose part
        on each follower is fn(*args, **kwargs) (`make`)."""
        self.make(fn, *args, local=lambda: obj, **kwargs)

    # -- collectives ------------------------------------------------------

    def rows(self, n: int) -> tuple:
        """This rank's rows [r0, r1) of n rows split over dp (n must divide
        it; `_rows_axis`)."""
        if _rows_axis(self, n) is None:
            return 0, n
        per = n // self.dp
        return self.dp_index * per, (self.dp_index + 1) * per

    def sum_tp(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the tp ranks (the psum that GSPMD puts after a
        row-parallel product): in place outside autograd (serving); under
        autograd a new tensor whose backward is the identity (Megatron's
        g, `_ReduceFromTP`)."""
        if self.tp_group is None:
            return x
        if torch.is_grad_enabled() and x.requires_grad:
            return _ReduceFromTP.apply(x, self.tp_group)
        dist.all_reduce(x, group=self.tp_group)
        return x

    def tp_input(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel product: x itself, whose gradient
        is summed over the tp ranks under autograd (Megatron's f,
        `_CopyToTP`): each rank's product sees only its columns."""
        if self.tp_group is None or not (torch.is_grad_enabled() and x.requires_grad):
            return x
        return _CopyToTP.apply(x, self.tp_group)

    def sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x summed over `axis` in place, outside autograd."""
        group = self.axis(axis)[2]
        if group is not None:
            dist.all_reduce(x, group=group)
        return x

    def sum_grads(self, leaves, axis: str) -> None:
        """Every leaf's .grad summed over `axis` (a leaf without one counts
        zeros), in one all-reduce of the gradients laid end to end in the
        leaves' order, which is the tree's on every rank. Runs after the
        backward, outside autograd: a dp sum of gradients, or the pp sum of
        the pipeline's replicated leaves."""
        group = self.axis(axis)[2]
        if group is None:
            return
        grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in leaves]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        for x, g in zip(leaves, flat.split([g.numel() for g in grads])):
            x.grad = g.view_as(x)

    def gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The ranks' x along `axis` concatenated along `dim`, in axis order
        (outside autograd)."""
        n, _, group = self.axis(axis)
        if group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    def gather_dp(self, x: torch.Tensor) -> torch.Tensor:
        """The dp ranks' x concatenated along dim 0, in dp order."""
        return self.gather(x, "dp")

    def shift(self, x: torch.Tensor, axis: str, by: int = 1) -> torch.Tensor:
        """The x of the rank `by` places before this one along `axis` (by -1:
        the one after), zeros where there is none: a pipeline's hop (by 1
        carries activations a stage down, by -1 gradients a stage up) or a
        sequence shard's left halo. One all_gather over the axis (HOP), of
        which each rank keeps one part; every rank of the axis must call it,
        in the same order, outside autograd."""
        n, i, group = self.axis(axis)
        if group is None:
            return torch.zeros_like(x)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        src = i - by
        return parts[src] if 0 <= src < n else torch.zeros_like(x)


class _CopyToTP(torch.autograd.Function):
    """Identity forward, gradient summed over the tp group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a copy: autograd may hand the same gradient tensor to other inputs
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """Sum over the tp group forward (into a new tensor), identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _rows_axis(mesh: Mesh, rows: int):
    """Batch rows split over dp when the mesh has that axis (rows must
    divide it: silent replication would be an invisible loss of data
    parallelism); a tp-only latency mesh replicates rows by design."""
    if "dp" not in mesh.axis_names:
        return None
    if rows % mesh.shape["dp"] != 0:
        raise ValueError(
            f"{rows} batch rows do not divide the dp axis "
            f"({mesh.shape['dp']} devices); pad the batch or resize the mesh")
    return "dp"


def kept(obj) -> bool:
    """True for an object kept on the ranks of a mesh (`Mesh.make`): a
    call's argument that each rank reads as its own part."""
    return id(obj) in _KEY_OF


def _forget(world, ident: int, key, ranks) -> None:
    """A kept object's leader part was collected: the followers' parts go
    with the next call."""
    if _KEY_OF.get(ident) == key:
        del _KEY_OF[ident]
    world.pending_release(key, ranks)


def on_mesh(fn=None, *, check=None):
    """A function that takes `mesh=`: called on the leader with a mesh, it
    runs on every rank of that mesh (`Mesh.call`); anywhere else, here.
    `check(*args, **kwargs)` runs first, so that a refusal raises on the
    leader before anything is sent."""
    if fn is None:
        return functools.partial(on_mesh, check=check)

    @functools.wraps(fn)
    def run(*args, **kwargs):
        mesh = kwargs.get("mesh")
        if mesh is not None:
            if check is not None:
                check(*args, **kwargs)
            if mesh.leads():
                return mesh.call(run, *args, **kwargs)
        return fn(*args, **kwargs)
    return run


def on_mesh_method(fn):
    """A method of an object with a `mesh` attribute, adopted on the mesh
    (`Mesh.adopt`): called on the leader, it runs on every rank's part."""
    @functools.wraps(fn)
    def run(self, *args, **kwargs):
        mesh = self.mesh
        if mesh is not None and mesh.leads():
            return mesh.call(run, self, *args, **kwargs)
        return fn(self, *args, **kwargs)
    return run


def visible_devices(n_devices: Optional[int] = None, device=None) -> list:
    """The devices of an n-rank mesh: the first n visible cards (device
    None; n defaults to all of them), or n ranks on `device` (n defaults to
    1). Without a card, device None raises."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return [device] * (n_devices or 1)
    from ..device import default_device
    default_device()                        # raises without a card
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f"a mesh of {n} cards: {count} visible")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(n_devices: Optional[int] = None, tp: Optional[int] = None,
              device=None) -> Mesh:
    """dp x tp mesh over the first n devices (`visible_devices`). tp
    defaults to the largest of 4 and 2 that divides n, else 1."""
    devices = visible_devices(n_devices, device)
    n = len(devices)
    if tp is None:
        tp = next((c for c in (4, 2) if n % c == 0), 1)
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    return Mesh(np.asarray(devices, dtype=object).reshape(n // tp, tp), ("dp", "tp"))


# ---------------------------------------------------------------------------
# parameter specs and shards
# ---------------------------------------------------------------------------

def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _llama_spec(num_layers: int) -> dict:
    layer = {
        "ln1": {"scale": P()},
        "q": {"w": P(None, "tp")},
        "k": {"w": P(None, "tp")},
        "v": {"w": P(None, "tp")},
        "o": {"w": P("tp", None)},
        "ln2": {"scale": P()},
        "gate": {"w": P(None, "tp")},
        "up": {"w": P(None, "tp")},
        "down": {"w": P("tp", None)},
    }
    return {"layers": [layer for _ in range(num_layers)], "norm": {"scale": P()}}


def t3_param_spec(t3_params) -> dict:
    """Spec tree for T3: Megatron tp on the backbone; the embeddings, the
    heads (the speech vocabulary's 8194 rows do not tile) and the
    conditioning replicate."""
    spec = _tree_map(lambda _: P(), t3_params)
    spec["llama"] = _llama_spec(len(t3_params["llama"]["layers"]))
    return spec


def flow_param_spec(flow_params) -> dict:
    """The CFM stack replicates."""
    return _tree_map(lambda _: P(), flow_params)


class ShardTree(dict):
    """A rank's tree of parameter shards (`shard_params`): a dict that a
    mesh call sends as its key, so that each rank reads its own."""


class _Leaf(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def _take_shards(tree, spec, mesh: Mesh, trainable: bool = False):
    """Each leaf broadcast from the leader over the mesh, and this rank's
    slice of it kept (on the leader `tree` holds the tensors, elsewhere
    their shapes and dtypes); `trainable`: each slice an fp32 copy that
    requires grad."""
    def take(leaf, s):
        if isinstance(leaf, torch.Tensor):
            buf = leaf.to(mesh.device).contiguous()
        else:
            buf = torch.empty(leaf.shape, dtype=leaf.dtype, device=mesh.device)
        if mesh.group is not None and buf.numel():
            dist.broadcast(buf.reshape(-1).view(torch.uint8), src=0, group=mesh.group)
        for dim, axis in enumerate(s):
            if axis is None:
                continue
            n, i, _ = mesh.axis(axis)
            if buf.shape[dim] % n:
                raise ValueError(f"dimension {dim} of {tuple(buf.shape)} does not divide "
                                 f"the {axis} axis ({n})")
            per = buf.shape[dim] // n
            buf = buf.narrow(dim, i * per, per).contiguous()
        if trainable:
            buf = buf.detach().to(torch.float32).clone().requires_grad_(True)
        return buf
    with torch.no_grad():
        return ShardTree(_tree_map(take, tree, spec))


def _unplaced(tree, spec, path=""):
    """Paths of `tree`'s leaves that `spec` has no entry for."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in (_unplaced(v, spec[k], f"{path}{k}/") if isinstance(spec, dict)
                          and k in spec else [f"{path}{k}"])]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree) for p in _unplaced(v, spec[i], f"{path}{i}/")]
    return []


def shard_params(params, spec, mesh: Mesh, trainable: bool = False):
    """Hand each rank its slice of every leaf of `params` (the leader's
    tree) by `spec`: the leader broadcasts each leaf once, and each rank
    keeps its part. Returns the leader's tree of shards (a replicated leaf
    already on the leader's device is the same tensor; with `trainable`
    every leaf is a fresh fp32 copy that requires grad), kept on every rank
    for the mesh's calls. A leaf the spec does not name raises: an int8
    backbone's w_q and scale among them, which the T3 spec (the JAX
    package's `_llama_spec`, naming "w" only) cannot place."""
    unplaced = _unplaced(params, spec)
    if unplaced:
        raise ValueError(f"shard_params: the spec places no {unplaced[0]}"
                         + (f" (and {len(unplaced) - 1} more leaves)" if len(unplaced) > 1 else "")
                         + ("; int8 weights cannot be placed on a mesh: the tp spec names "
                            "only a linear's 'w', as the JAX package's does"
                            if any(p.endswith(("/w_q", "/scale")) for p in unplaced) else ""))
    skeleton = _tree_map(lambda x: _Leaf(tuple(x.shape), x.dtype), params)
    return mesh.make(_take_shards, skeleton, spec, mesh, trainable,
                     local=lambda: _take_shards(params, spec, mesh, trainable))
