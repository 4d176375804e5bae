"""The collective layer of a mesh: ``all_reduce``, ``all_gather`` and
``reduce_scatter`` over one axis group of a ``DeviceMesh`` — the model
axis, or the folded data axes (``("pod", "data")`` as one flattened
group) — on the process group's own backend.

``MeshComm(mesh, geometry)`` makes one process group per axis group (all
ranks make every group, in one order, as ``torch.distributed.new_group``
requires) and knows this rank's index in each. A tensor stays on its
device and the group's backend is the one the caller initialised.

Every call adds its bytes to a private record, read with
``last_collectives()`` and zeroed with ``reset_collectives()`` (in the
manner of ``kernels.common.last_launches``): per collective, the calls
and the bytes this rank put in (an all-gather's local shard, an
all-reduce's or a reduce-scatter's whole input).
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

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
    ``reset_collectives``: ``group`` is "data" or "model"."""
    return {k: dict(v) for k, v in _RECORD.items()}


def _note(op: str, kind: str, t: torch.Tensor) -> None:
    rec = _RECORD.setdefault(f"{op}/{kind}", {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()


class MeshComm:
    """Process groups and this rank's coordinates on a (data × model)
    mesh: ``size[kind]`` and ``index[kind]`` for ``kind`` in ("data",
    "model"), and the collectives over each."""

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
        axes = {"data": tuple(geometry.data_axes), "model": (geometry.model_axis,)}
        self.size: Dict[str, int] = {}
        self.index: Dict[str, int] = {}
        self.groups: Dict[str, Optional[dist.ProcessGroup]] = {}
        for kind in ("data", "model"):
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
    walks over ``meta`` tensors (the engine's lowering at shard shapes):
    nothing is communicated or recorded."""

    def __init__(self, comm):
        self.geometry = comm.geometry
        self.size = dict(comm.size)
        self.index = dict(comm.index)

    def all_reduce(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        return t

    def all_gather(self, t: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        shape = list(t.shape)
        shape[dim] *= self.size[kind]
        return t.new_empty(shape)

    def reduce_scatter(self, t: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
        return t.narrow(dim, 0, t.shape[dim] // self.size[kind])
