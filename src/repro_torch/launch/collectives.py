"""The collective layer of a mesh: ``all_reduce``, ``all_gather`` and
``reduce_scatter`` over one axis group of a ``DeviceMesh`` — the model
axis, or the folded data axes (``("pod", "data")`` as one flattened
group) — on the process group's own backend.

``MeshComm(mesh, geometry)`` makes one process group per axis group (all
ranks make every group, in one order, as ``torch.distributed.new_group``
requires) and knows this rank's index in each. A tensor stays on its
device and the group's backend is the one the caller initialised. The
groups are "model" and "data" (the geometry's data axes, folded); where
the mesh has a "pod" axis that the geometry leaves out of its data axes
(a language model's placement, whose FSDP runs over "data" alone), also
"pod" and "batch", the ("pod", "data") fold its batch is cut over.

Every call adds its bytes to a private record, read with
``last_collectives()`` and zeroed with ``reset_collectives()`` (in the
manner of ``kernels.common.last_launches``): per collective, the calls
and the bytes this rank put in (an all-gather's local shard, an
all-reduce's or a reduce-scatter's whole input). ``ShapeComm`` keeps a
record of its own, with the same keys, of what a walk over ``meta``
tensors would move.

``broadcast_object`` and ``broadcast`` send rank 0's Python object or
tensor to every rank of the mesh (its whole group), as a serving endpoint
over several ranks sends each step's header; their calls are recorded
under op "broadcast", group "mesh".

The ``MeshComm`` calls are forward-only. The functions at the end of the
module are the collectives autograd runs through, each backward the
transposed collective, as a language model on a mesh uses them
(``launch/sharding.py``): ``reduce_from`` (all-reduce forward, identity
backward) and ``copy_to`` (identity forward, all-reduce backward), the
pair around a tensor-parallel layer; ``gather_from`` (all-gather forward,
the rank's slice backward) and ``scatter_to`` (the rank's slice forward,
all-gather backward) for activations whose downstream every rank
computes alike; ``all_gather`` (all-gather forward, reduce-scatter
backward) and ``reduce_scatter`` (the reverse) for parameters sharded
over the data ranks, whose gradients each rank holds a part of. Each
keeps its ``MeshComm`` on the autograd context: autograd runs a CUDA
backward on a thread of its own. Their calls go into the same record.
"""

from __future__ import annotations

import itertools
import math
import pickle
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.planner import DATA_AXIS_NAMES

_RECORD: Dict[str, Dict[str, int]] = {}

# the one-tensor all-gather and reduce-scatter, under their newer names
# where this torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reset_collectives() -> None:
    """Zero the record of collectives."""
    _RECORD.clear()


def last_collectives() -> Dict[str, Dict[str, int]]:
    """``{"<op>/<group>": {"calls", "bytes"}}`` since the last
    ``reset_collectives``: ``group`` is "data", "model", "pod" or
    "batch"."""
    return {k: dict(v) for k, v in _RECORD.items()}


def _note(op: str, kind: str, t: torch.Tensor, record=None) -> None:
    rec = (_RECORD if record is None else record).setdefault(f"{op}/{kind}", {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()


def axis_groups(names, geometry) -> Dict[str, Tuple[str, ...]]:
    """The axis groups of a mesh whose axes are ``names`` under
    ``geometry``, {kind: axes}, in the order every rank makes them (module
    docstring)."""
    axes = {"data": tuple(geometry.data_axes), "model": (geometry.model_axis,)}
    if "pod" in names and "pod" not in geometry.data_axes:
        axes["pod"] = ("pod",)
        axes["batch"] = tuple(a for a in DATA_AXIS_NAMES if a in names)
    return axes


class MeshComm:
    """Process groups and this rank's coordinates on a (data × model)
    mesh, or a (pod × data × model) one: ``size[kind]`` and
    ``index[kind]`` for each kind of ``axis_groups`` ("data", "model", and
    on a pod axis the geometry leaves out "pod" and "batch"), and the
    collectives over each."""

    def __init__(self, mesh, geometry):
        self.mesh = mesh
        self.geometry = geometry
        names = tuple(mesh.mesh_dim_names)
        ranks = mesh.mesh  # rank at each mesh position
        me = dist.get_rank()
        pos = [tuple(int(i) for i in p) for p in (ranks == me).nonzero()]
        if len(pos) != 1:
            raise ValueError(f"rank {me} is not on the mesh {mesh}")
        pos = pos[0]
        axes = axis_groups(names, geometry)
        #: the global rank at each mesh position, in mesh order, and this
        #: rank's index among them
        self.ranks: Tuple[int, ...] = tuple(int(r) for r in ranks.flatten())
        self.position = self.ranks.index(me)
        #: the group of every rank of the mesh (None: the default group,
        #: which the mesh spans whole)
        self.whole = (None if len(self.ranks) == dist.get_world_size()
                      else dist.new_group(sorted(self.ranks)))
        self.size: Dict[str, int] = {}
        self.index: Dict[str, int] = {}
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for kind in axes:
            dims = [names.index(a) for a in axes[kind] if a in names]
            others = [d for d in range(len(names)) if d not in dims]
            size = 1
            for d in dims:
                size *= int(ranks.shape[d])
            self.size[kind] = size
            # this rank's index in the group: its coordinates on the
            # group's axes, flattened in fold order
            idx = 0
            for d in dims:
                idx = idx * int(ranks.shape[d]) + pos[d]
            self.index[kind] = idx
            self.groups[kind] = None
            if size == 1:
                continue
            for other in itertools.product(*(range(int(ranks.shape[d])) for d in others)):
                members = []
                for inner in itertools.product(*(range(int(ranks.shape[d])) for d in dims)):
                    at = [0] * len(names)
                    for d, i in zip(others, other):
                        at[d] = i
                    for d, i in zip(dims, inner):
                        at[d] = i
                    members.append(int(ranks[tuple(at)]))
                group = dist.new_group(members)
                if me in members:
                    self.groups[kind] = group

    def all_reduce(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """Σ of ``t`` over the ranks of the ``kind`` group (a new tensor)."""
        if self.size[kind] == 1:
            return t
        _note("all_reduce", kind, t)
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.groups[kind])
        return out

    def all_gather(self, t: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        """The ``kind`` group's shards of ``t`` concatenated along ``dim``
        in group-index order."""
        if self.size[kind] == 1:
            return t
        _note("all_gather", kind, t)
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] * self.size[kind],) + tuple(src.shape[1:]))
        _ALL_GATHER(out, src, group=self.groups[kind])
        return out.movedim(0, dim)

    def reduce_scatter(self, t: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        """Σ of ``t`` over the ``kind`` group, of which this rank keeps its
        slice of ``dim`` (its extent must divide by the group's size)."""
        if self.size[kind] == 1:
            return t
        _note("reduce_scatter", kind, t)
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // self.size[kind],) + tuple(src.shape[1:]))
        _REDUCE_SCATTER(out, src, group=self.groups[kind])
        return out.movedim(0, dim)


def broadcast_object(obj, comm: MeshComm, src: int = 0, *, group=None):
    """Mesh rank ``src``'s ``obj`` (picklable) on every rank of the mesh:
    ``obj`` is read on ``src`` only, and each rank returns the object sent.
    ``group`` is a group of the same ranks to send it over (a serving
    endpoint's, whose timeout bounds a rank's wait), else the mesh's
    whole group. Not differentiable."""
    box = [obj if comm.position == src else None]
    dist.broadcast_object_list(box, src=comm.ranks[src], group=comm.whole if group is None else group)
    rec = _RECORD.setdefault("broadcast/mesh", {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += len(pickle.dumps(box[0]))
    return box[0]


def broadcast(t: torch.Tensor, comm: MeshComm, src: int = 0) -> torch.Tensor:
    """Mesh rank ``src``'s ``t`` on every rank of the mesh: the other
    ranks pass a contiguous tensor of its shape and dtype, which is filled
    in place and returned. Not differentiable."""
    _note("broadcast", "mesh", t)
    dist.broadcast(t, src=comm.ranks[src], group=comm.whole)
    return t


_COMMS: Dict[Tuple[int, object], MeshComm] = {}


def comm_for(mesh, geometry) -> MeshComm:
    """The (cached) ``MeshComm`` of ``mesh`` under ``geometry``. Every rank
    must reach its first call at the same point of its program: it makes
    the groups."""
    key = (id(mesh), geometry)
    hit = _COMMS.get(key)
    if hit is None or hit.mesh is not mesh:
        hit = _COMMS[key] = MeshComm(mesh, geometry)
    return hit



class ShapeComm:
    """A ``MeshComm``'s sizes and indices with shape-only collectives, for
    walks over ``meta`` tensors (the engine's lowering at shard shapes; a
    language model's step on a mesh given by its axis sizes, as
    ``launch/dryrun.py`` walks it): nothing is communicated. Each call
    adds to ``record`` what ``MeshComm`` would record for it (the same
    keys as ``last_collectives()``), and a group of one rank records
    nothing, as there. A tensor with values refuses: the collectives of a
    mesh without ranks cannot sum them."""

    def __init__(self, comm):
        self.geometry = comm.geometry
        self.size = dict(comm.size)
        self.index = dict(comm.index)
        self.record: Dict[str, Dict[str, int]] = {}

    @classmethod
    def of_sizes(cls, sizes, geometry) -> "ShapeComm":
        """Rank 0's shape-only collectives on a mesh of axis ``sizes``
        ({axis: size}) under ``geometry``."""
        self = cls.__new__(cls)
        self.geometry = geometry
        self.size = {kind: math.prod(int(sizes[a]) for a in axes if a in sizes)
                     for kind, axes in axis_groups(tuple(sizes), geometry).items()}
        self.index = dict.fromkeys(self.size, 0)
        self.record = {}
        return self

    def collectives(self) -> Dict[str, Dict[str, int]]:
        """``record`` as ``last_collectives()`` gives it."""
        return {k: dict(v) for k, v in self.record.items()}

    def _walk(self, op: str, kind: str, t: torch.Tensor) -> None:
        if t.device.type != "meta":
            raise ValueError(f"{op} over {kind!r} of a mesh given by its axis sizes takes meta tensors only: "
                             f"it moves nothing, so a {t.device.type} tensor's sum would be wrong (start "
                             "ranks and pass a DeviceMesh to run a step)")
        if self.size[kind] > 1:
            _note(op, kind, t, self.record)

    def all_reduce(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        self._walk("all_reduce", kind, t)
        return t if self.size[kind] == 1 else t.clone()

    def all_gather(self, t: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        self._walk("all_gather", kind, t)
        if self.size[kind] == 1:
            return t
        shape = list(t.shape)
        shape[dim] *= self.size[kind]
        return t.new_empty(shape)

    def reduce_scatter(self, t: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        self._walk("reduce_scatter", kind, t)
        if self.size[kind] == 1:
            return t
        return t.narrow(dim, 0, t.shape[dim] // self.size[kind]).clone()


# ---------------------------------------------------------------------------
# Collectives autograd runs through
# ---------------------------------------------------------------------------


def _slice(comm: MeshComm, t: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
    """This rank's slice of ``dim`` in the ``kind`` group."""
    n = t.shape[dim] // comm.size[kind]
    return t.narrow(dim, comm.index[kind] * n, n).contiguous()


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, kind):
        ctx.comm, ctx.kind = comm, kind
        return comm.all_reduce(t, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, kind):
        ctx.comm, ctx.kind = comm, kind
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous(), ctx.kind), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, dim, kind):
        ctx.comm, ctx.dim, ctx.kind = comm, dim, kind
        return comm.all_gather(t, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return _slice(ctx.comm, g, ctx.dim, ctx.kind), None, None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, dim, kind):
        ctx.comm, ctx.dim, ctx.kind = comm, dim, kind
        return _slice(comm, t, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim, ctx.kind), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, dim, kind):
        ctx.comm, ctx.dim, ctx.kind = comm, dim, kind
        return comm.all_gather(t, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g, ctx.dim, ctx.kind), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, dim, kind):
        ctx.comm, ctx.dim, ctx.kind = comm, dim, kind
        return comm.reduce_scatter(t, dim, kind)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_gather(g, ctx.dim, ctx.kind), None, None, None


def reduce_from(t: torch.Tensor, comm: MeshComm, kind: str = "model") -> torch.Tensor:
    """Σ of the ``kind`` group's partials forward; the gradient passes
    unchanged (Megatron's g)."""
    return t if comm.size[kind] == 1 else _ReduceFrom.apply(t, comm, kind)


def copy_to(t: torch.Tensor, comm: MeshComm, kind: str = "model") -> torch.Tensor:
    """``t`` unchanged forward; the group's partial gradients summed
    backward (Megatron's f)."""
    return t if comm.size[kind] == 1 else _CopyTo.apply(t, comm, kind)


def gather_from(t: torch.Tensor, comm: MeshComm, dim: int, kind: str = "model") -> torch.Tensor:
    """The group's shards concatenated on ``dim`` forward; the rank's slice
    of the gradient backward (every rank's gradient of the whole is the
    same)."""
    return t if comm.size[kind] == 1 else _GatherFrom.apply(t, comm, dim % t.dim(), kind)


def scatter_to(t: torch.Tensor, comm: MeshComm, dim: int, kind: str = "model") -> torch.Tensor:
    """The rank's slice of ``dim`` forward; the slices' gradients
    concatenated backward."""
    return t if comm.size[kind] == 1 else _ScatterTo.apply(t, comm, dim % t.dim(), kind)


def all_gather(t: torch.Tensor, comm: MeshComm, dim: int, kind: str = "data") -> torch.Tensor:
    """The group's shards concatenated on ``dim`` forward; the gradient
    summed over the group and cut to the rank's slice backward."""
    return t if comm.size[kind] == 1 else _AllGather.apply(t, comm, dim % t.dim(), kind)


def reduce_scatter(t: torch.Tensor, comm: MeshComm, dim: int, kind: str = "data") -> torch.Tensor:
    """Σ over the group, cut to the rank's slice of ``dim``, forward; the
    slices' gradients concatenated backward."""
    return t if comm.size[kind] == 1 else _ReduceScatter.apply(t, comm, dim % t.dim(), kind)
