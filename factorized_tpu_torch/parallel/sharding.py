"""Meshes of processes and data- and tensor-parallel training over
``torch.distributed`` (port of ``factorized_tpu/parallel/sharding.py``).

One process a device: JAX's global mesh over every visible device is
here the world of ranks, laid out on the mesh's axes (``Mesh``), with
one process group for each slice of the mesh along an axis (``Group``).
The collectives are NCCL between cards and gloo on the CPU; a gloo
group whose tensors live on a card stages them through pinned host
memory, chosen when the group is made. A slice of one rank issues no
collective, so a world of one computes exactly what an unsharded run
does.

- ``DataParallel``: parameters replicated from rank 0, the batch axis of
  the epoch tensor cut over ``data``; its ``program`` is a
  ``train.TrainProgram`` whose step all-reduces the flat gradient once
  (``ops.rows`` makes the draws and the MMD those of the global batch).
- ``tp_param_shardings``: on a 2-D ``("data", "model")`` mesh, the
  listed weights' columns cut over ``model``, gathered before use.
"""

from __future__ import annotations

import contextlib
import os
import socket
from itertools import combinations
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from factorized_tpu_torch import resolve_device
from factorized_tpu_torch.ops import rows
from factorized_tpu_torch.train import TrainProgram, leaves

# the rank's device, as ``init_distributed`` chose it
_DEVICE = None


def _env_int(*names):
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def free_port() -> int:
    """A free TCP port on 127.0.0.1."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_rank(process_id: int = 0) -> int:
    """torchrun's ``LOCAL_RANK``, else ``process_id`` modulo the cards."""
    lr = _env_int("LOCAL_RANK")
    if lr is not None:
        return lr
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return process_id % max(n, 1)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device=None, backend: Optional[str] = None) -> bool:
    """Join the world of ranks: ``torch.distributed.init_process_group``.

    Precedence per field: the explicit argument, then torchrun's
    ``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, then
    the JAX package's ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES``
    / ``JAX_PROCESS_ID``, so a launcher written for the JAX package
    starts this one unchanged. With no coordinator and at most one
    process, a world of one on a free port of 127.0.0.1.

    The rank's device is ``device``, else ``cuda:LOCAL_RANK`` (made the
    current card); the backend ``backend``, else NCCL on a card and gloo
    on the CPU. Returns False, doing nothing, when a process group
    already exists; True after joining."""
    global _DEVICE
    if dist.is_initialized():
        return False
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                f"{os.environ.get('MASTER_PORT', '29500')}")
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE", "JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("RANK", "JAX_PROCESS_ID")
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    if coordinator_address is None:
        if num_processes > 1:
            raise ValueError(
                f"init_distributed: {num_processes} processes need a "
                "coordinator address (host:port): pass it, or set "
                "MASTER_ADDR/MASTER_PORT (torchrun) or "
                "JAX_COORDINATOR_ADDRESS")
        coordinator_address = f"127.0.0.1:{free_port()}"
    dev = torch.device(device if device is not None
                       else f"cuda:{local_rank(process_id)}")
    if dev.type == "cuda":
        dev = resolve_device(dev)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            rank=process_id, world_size=num_processes)
    _DEVICE = dev
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """Whether this rank writes the logs, checkpoints and snapshots: rank
    0 of the world (the only rank of an unsharded run)."""
    return world_rank() == 0


def rank_device(device=None) -> torch.device:
    """``device``, else the one ``init_distributed`` chose, else the
    card."""
    if device is not None:
        return resolve_device(device)
    return _DEVICE if _DEVICE is not None else resolve_device(None)


class Group:
    """One slice of a mesh: its world ``ranks`` in order, this rank's
    ``index`` among them and their process group (None for one rank).
    The collectives take tensors on any device and give them back there:
    NCCL's on the card, gloo's on the host (a card's tensor is staged
    through pinned host memory)."""

    def __init__(self, ranks, index, pg=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.size = len(self.ranks)
        self.index = index
        self.share = 1.0 / self.size
        self.pg = pg
        self.backend = dist.get_backend(pg) if pg is not None else None

    def _comm(self, t):
        """``t`` where the backend reads it."""
        if self.backend == "nccl":
            return t.to(rank_device())
        if t.device.type == "cuda":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return host.copy_(t)
        return t.contiguous()

    def all_reduce_(self, t):
        """Sums ``t`` over the group in place: the collective reads and
        writes ``t`` itself where the backend reads its device (NCCL, gloo
        on the CPU), a pinned host copy of it where it does not."""
        if self.pg is None:
            return t
        buf = self._comm(t)
        dist.all_reduce(buf, group=self.pg)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t, axis=0):
        """Every rank's ``t`` concatenated along ``axis``, in rank
        order."""
        if self.pg is None:
            return t
        if t.dtype == torch.bool:
            return self.all_gather(t.to(torch.uint8), axis).bool()
        buf = self._comm(t)
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.pg)
        return torch.cat(parts, dim=axis).to(t.device)

    def broadcast_(self, t, src_index=0):
        """``t`` from the group's rank ``src_index`` into every rank's, in
        place."""
        if self.pg is None:
            return t
        buf = self._comm(t)
        dist.broadcast(buf, src=self.ranks[src_index], group=self.pg)
        t.copy_(buf)
        return t

    def gather_objects(self, obj):
        """Every rank's picklable ``obj``, a list in rank order."""
        if self.pg is None:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.pg)
        return out

    def rows(self):
        """The context of a step sharded by rows over this group
        (``ops.rows``); none for one rank."""
        if self.pg is None:
            return contextlib.nullcontext()
        return rows.sharded_rows(self)


class Mesh:
    """World ranks laid out on named axes (the JAX package's
    ``jax.sharding.Mesh``): ``devices`` is the array of ranks,
    ``axis_names`` and ``shape`` ({axis: size}) as JAX's. ``member`` says
    whether this rank is in the mesh, ``coords`` its place ({axis:
    index}), ``device`` its device, ``partial`` whether the world holds
    ranks outside it. ``group(*axes)`` is the slice along ``axes``
    through this rank; ``group()`` the whole mesh. Every rank of the
    world makes the same mesh: process groups are made by all ranks, in
    one order."""

    def __init__(self, ranks, axis_names, device=None):
        ranks = np.asarray(ranks)
        self.devices = ranks
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, ranks.shape))
        self.size = int(ranks.size)
        self.device = device
        self.rank = world_rank()
        where = np.argwhere(ranks == self.rank)
        self.member = bool(where.size)
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if self.member else None)
        self.partial = self.size < world_size()
        self._groups = {axes: self._make(axes)
                        for r in range(1, len(self.axis_names) + 1)
                        for axes in combinations(self.axis_names, r)}

    def _make(self, axes):
        """The slices along ``axes``, each a process group made by every
        rank; returns the one through this rank."""
        keep = [self.axis_names.index(a) for a in axes]
        lanes = np.moveaxis(self.devices, keep, list(range(len(keep))))
        lanes = lanes.reshape(int(np.prod(lanes.shape[:len(keep)])), -1)
        mine = None
        for col in range(lanes.shape[1]):
            members = [int(r) for r in lanes[:, col]]
            pg = None
            if len(members) == world_size() > 1:
                pg = dist.group.WORLD
            elif len(members) > 1:
                pg = dist.new_group(members)
            if self.rank in members:
                mine = Group(members, members.index(self.rank), pg)
        return mine

    def group(self, *axes) -> Optional[Group]:
        """The slice along ``axes`` through this rank, the whole mesh with
        none; None outside the mesh."""
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(axes):
            raise ValueError(f"the mesh's axes are {self.axis_names}, not "
                             f"all of {axes}")
        return self._groups[key or self.axis_names]


def make_mesh(n_devices: Optional[int] = None,
              axes: Sequence[str] = ("data",),
              shape: Optional[Sequence[int]] = None,
              multihost: bool = False, device=None) -> Mesh:
    """A mesh over the first ``n_devices`` ranks of the world (all of
    them by default), shaped ``shape`` (``_default_2d_shape`` for two
    axes). ``multihost`` joins the world first (``init_distributed``).
    ``device``: the rank's device (``rank_device``)."""
    if multihost:
        init_distributed(device=device)
    world = world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(
            f"make_mesh: need {n} devices, have {world} rank(s) in the "
            f"world (one process a device). Start {n} ranks: e.g. "
            f"torchrun --nproc-per-node {n} ... with --multihost, or "
            "parallel.multiprocess.launch(n_processes, local_devices), "
            "each rank joining through init_distributed().")
    if shape is None:
        shape = (n,) if len(axes) == 1 else _default_2d_shape(n, axes)
    if int(np.prod(shape)) != n or len(shape) != len(axes):
        raise ValueError(f"make_mesh: shape {tuple(shape)} does not lay "
                         f"{n} devices on axes {tuple(axes)}")
    return Mesh(np.arange(n).reshape(shape), axes,
                device=rank_device(device))


def _default_2d_shape(n: int, axes) -> tuple:
    """Default 2-axis mesh split: prefer ``(n//2, 2)``; for odd
    composite ``n`` use the smallest odd factor; refuse loudly for
    prime ``n>2`` instead of letting numpy reshape throw a raw error."""
    if n == 1:
        return (1, 1)
    if n % 2 == 0:
        return (n // 2, 2)
    p = next((f for f in range(3, int(n ** 0.5) + 1, 2) if n % f == 0),
             None)
    if p is None:
        raise ValueError(
            f"make_mesh: cannot pick a default 2-D shape for "
            f"axes={tuple(axes)} over {n} devices ({n} is prime). "
            f"Pass shape=(a, b) with a*b == {n} explicitly, or use a "
            "device count that factors (e.g. n_devices=n-1)."
        )
    return (n // p, p)


class DataParallel:
    """Data-parallel training over the mesh's ``data`` axis."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n = mesh.shape["data"]
        self.group = mesh.group("data")

    def params(self, params):
        """A parameter tree replicated from rank 0 over the whole mesh,
        in place."""
        whole = self.mesh.group()
        with torch.no_grad():
            for leaf in leaves(params):
                whole.broadcast_(leaf)
        return params

    def epoch_batches(self, Xb, yb):
        """This rank's ``B / n`` columns of the epoch tensor (nb, t, B,
        d) and labels (nb, B)."""
        assert Xb.shape[2] % self.n == 0, (
            f"batch {Xb.shape[2]} not divisible by mesh data={self.n}"
        )
        b = Xb.shape[2] // self.n
        i = self.group.index
        return (_contiguous(Xb[:, :, i * b:(i + 1) * b]),
                _contiguous(yb[:, i * b:(i + 1) * b]))

    def full_set(self, X, y=None):
        """A full-set batch (t, N, d) padded with zero rows to the mesh
        and cut to this rank's rows: ``(X, n)`` or ``(X, y, n)`` with
        ``n`` the true N (``gather`` puts the rows back together)."""
        t, n, d = X.shape
        pad = (-n) % self.n
        X = _pad_rows(X, pad, 1)
        b = (n + pad) // self.n
        i = self.group.index
        X = _contiguous(X[:, i * b:(i + 1) * b])
        if y is None:
            return X, n
        y = _contiguous(_pad_rows(y, pad, 0)[i * b:(i + 1) * b])
        return X, y, n

    def gather(self, t, n, axis=0):
        """Every rank's rows of ``t`` (a result of ``full_set``'s rows)
        along ``axis``, cut to the true ``n``."""
        return self.group.all_gather(t, axis).narrow(axis, 0, n)

    def program(self, apply_fn, cfg, variant: str = "joint", **kw):
        """A ``TrainProgram`` whose step is data-parallel over ``data``:
        each rank's loss over its rows scaled by its share, the flat
        gradient and the tracked loss summed over the group in one
        all-reduce, then the same update on every rank."""
        group = self.group if self.group.size > 1 else None
        return TrainProgram(apply_fn, cfg, variant, data=group, **kw)


def _contiguous(a):
    return (a.contiguous() if isinstance(a, torch.Tensor)
            else np.ascontiguousarray(a))


def _pad_rows(a, pad, axis):
    if not pad:
        return a
    shape = list(a.shape)
    shape[axis] = pad
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros(shape)], dim=axis)
    return np.concatenate([a, np.zeros(shape, a.dtype)], axis=axis)


def _path_str(path):
    return "/".join(path)


class TensorParallel:
    """Weights cut by columns over the mesh's ``model`` axis
    (``tp_param_shardings``): ``params`` is this rank's tree, each listed
    weight its slice of columns; ``apply(apply_fn)`` gathers them before
    use (the gradient of a slice is its columns' gradient); ``full(tree)``
    puts a tree of slices back together."""

    def __init__(self, params, group, sharded):
        self.params = params
        self.group = group
        self.sharded = sharded

    def _map(self, tree, fn, path=()):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            out[k] = (self._map(v, fn, p) if isinstance(v, dict)
                      else fn(v, self.sharded.get(_path_str(p))))
        return out

    def gathered(self, tree):
        """``tree`` with each slice gathered whole (differentiable)."""
        group = self.group

        def full(leaf, axis):
            if axis is None:
                return leaf
            return rows.GatherShards.apply(leaf, axis, group, 1.0)

        return self._map(tree, full)

    def apply(self, apply_fn):
        """``apply_fn`` over the gathered weights."""
        def fn(params, x, cfg, **kw):
            return apply_fn(self.gathered(params), x, cfg, **kw)

        return fn

    def full(self, tree):
        """A tree of slices as whole weights (copies)."""
        with torch.no_grad():
            return self._map(self.gathered(tree), lambda v, a: v.clone())


def tp_param_shardings(mesh: Mesh, params, rules=None) -> TensorParallel:
    """Tensor-parallel shardings of the widest projection weights, with DP
    over ``data`` on a 2-D ``("data", "model")`` mesh: each weight a rule
    (``(path_substring, axis)``) matches keeps this rank's slice of its
    ``axis`` over ``model``. The default cuts the text decoder's output
    projection and recurrent weights. Returns a ``TensorParallel`` (its
    ``params`` the rank's tree), where the JAX package returns the tree
    placed with its shardings.

    A rule that MATCHES a weight whose sharded dim does not divide the
    'model' axis raises: silently replicating it would leave the user
    believing they enabled TP while actually running DP."""
    if rules is None:
        rules = [("decoder_l/fc1/w", 1), ("decoder_l/lstm/wx", 1),
                 ("decoder_l/lstm/wh", 1)]
    n_model = mesh.shape["model"]
    j = mesh.coords["model"]
    sharded = {}

    def assign(tree, path=()):
        out = {}
        for k, leaf in tree.items():
            p = path + (k,)
            if isinstance(leaf, dict):
                out[k] = assign(leaf, p)
                continue
            ps = _path_str(p)
            out[k] = leaf
            for sub, axis in rules:
                if sub in ps and getattr(leaf, "ndim", 0) == 2:
                    if leaf.shape[axis] % n_model:
                        raise ValueError(
                            f"tensor-parallel rule {sub!r} matches weight "
                            f"{ps} with shape {tuple(leaf.shape)}, but dim "
                            f"{axis} ({leaf.shape[axis]}) does not divide "
                            f"the mesh 'model' axis ({n_model}) - shard a "
                            "divisible weight, resize the model, or drop "
                            "the rule (silently replicating would be DP "
                            "masquerading as TP)")
                    w = leaf.shape[axis] // n_model
                    out[k] = torch.as_tensor(leaf).narrow(
                        axis, j * w, w).clone()
                    sharded[ps] = axis
                    break
        return out

    return TensorParallel(assign(params), mesh.group("model"), sharded)
