"""Chunked relation representations for the compiled path (Appendix A).

Two physical layouts, mirroring what a tensor-relational engine stores:

  DenseRelation — the key set is a full grid range(n₀)×…×range(n_{d-1});
      tuples are laid out as one tensor of shape (n₀,…,n_{d-1}, *chunk).
      This is the layout for blocked matrices/tensors (paper §2.1 Fig 1).

  CooRelation — sparse key set: an int32 key tensor (nnz, d) plus a value
      tensor (nnz, *chunk) and per-column extents. This is the layout for
      graph edge relations (paper §1 GCN example).

Both carry ``chunk_rank`` — the number of trailing value ("chunk") dims —
so executors can separate block-key axes from within-chunk axes. They are
plain dataclasses holding tensors on one device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

#: sentinel key component marking padded COO rows (see ``pad_coo_nnz``):
#: every lowering that consumes COO keys drops out-of-range ids, so padded
#: rows contribute nothing to gathers or segment sums.
COO_PAD_KEY = -1


@dataclass
class DenseRelation:
    data: torch.Tensor
    key_arity: int

    @property
    def chunk_rank(self) -> int:
        return self.data.dim() - self.key_arity

    @property
    def extents(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[: self.key_arity])

    @property
    def chunk_shape(self) -> Tuple[int, ...]:
        return tuple(self.data.shape[self.key_arity:])

    def to_sparse(self) -> dict:
        """Materialize as dict for interpreter cross-checks (small inputs)."""
        out = {}
        arr = self.data.detach().cpu().numpy()
        for key in np.ndindex(*self.extents):
            v = arr[key]
            out[tuple(int(i) for i in key)] = v if self.chunk_rank else float(v)
        return out


@dataclass
class CooRelation:
    """Sparse relation: ``keys`` (nnz, d) int32 + ``values`` (nnz, *chunk).

    ``owner_dim`` / ``shard_offsets`` describe an owner-partitioned nnz
    layout (rows sorted by one key column); they are static schema like
    ``extents`` and ``None`` means unpartitioned.
    """

    keys: torch.Tensor    # (nnz, key_arity) int32
    values: torch.Tensor  # (nnz, *chunk)
    extents: Tuple[int, ...]
    owner_dim: Optional[int] = None
    shard_offsets: Optional[Tuple[int, ...]] = None

    @property
    def key_arity(self) -> int:
        return int(self.keys.shape[1])

    @property
    def nnz(self) -> int:
        return int(self.keys.shape[0])

    @property
    def chunk_rank(self) -> int:
        return self.values.dim() - 1

    @property
    def chunk_shape(self) -> Tuple[int, ...]:
        return tuple(self.values.shape[1:])

    def to_sparse(self) -> dict:
        out = {}
        keys = self.keys.detach().cpu().numpy()
        vals = self.values.detach().cpu().numpy()
        for i in range(keys.shape[0]):
            k = tuple(int(x) for x in keys[i])
            v = vals[i]
            out[k] = v if self.chunk_rank else float(v)
        return out


Relation = (DenseRelation, CooRelation)


def scalar_relation(value=1.0, dtype=torch.float32, device=None) -> DenseRelation:
    """The one-tuple relation {(⟨⟩, value)} — loss outputs / gradient seeds."""
    return DenseRelation(torch.as_tensor(value, dtype=dtype, device=device), key_arity=0)


def pad_coo_nnz(rel: CooRelation, target_nnz: int) -> CooRelation:
    """Pad the nnz axis up to ``target_nnz`` rows with ``COO_PAD_KEY`` keys
    and zero values. Padded rows are inert: every key column is out of
    range, so gathers mask them to zero and segment sums drop them."""
    pad = target_nnz - rel.nnz
    if pad < 0:
        raise ValueError(
            f"pad_coo_nnz: target {target_nnz} < nnz {rel.nnz}"
        )
    if pad == 0:
        return rel
    keys = torch.cat(
        [rel.keys, rel.keys.new_full((pad, rel.key_arity), COO_PAD_KEY)], dim=0
    )
    values = torch.cat(
        [rel.values, rel.values.new_zeros((pad,) + rel.chunk_shape)], dim=0
    )
    return CooRelation(keys, values, rel.extents, rel.owner_dim, rel.shard_offsets)


def measure_stats(rel):
    """Measure a relation's key-domain statistics — the
    ``planner.RelationStats`` a ``Database`` catalog tracks per table and
    refreshes on ``put``.

    DenseRelation key sets are full grids, so every statistic is exact
    and free. CooRelation key columns are copied to the host once and
    counted with ``np.unique`` / ``np.histogram`` over the live
    (non-padded) rows — a data-loading step, never one of the step's."""
    from .planner import HIST_BUCKETS, RelationStats

    def column_hist(values, extent, per_value=1):
        """Equi-width tuple counts over ``[0, extent)``."""
        if extent <= 0:
            return tuple([0] * HIST_BUCKETS)
        counts, _ = np.histogram(
            values, bins=HIST_BUCKETS, range=(0, extent)
        )
        return tuple(int(c) * int(per_value) for c in counts)

    if isinstance(rel, DenseRelation):
        extents = rel.extents
        size = 1
        for e in extents:
            size *= int(e)
        hist = tuple(
            column_hist(
                np.arange(int(e)), int(e), size // int(e) if int(e) else 0
            )
            for e in extents
        )
        return RelationStats(
            distinct=tuple(int(e) for e in extents),
            extents=tuple(int(e) for e in extents),
            nnz=size,
            density=1.0,
            hist=hist,
        )
    if isinstance(rel, CooRelation):
        keys = rel.keys.detach().cpu().numpy()
        live = keys[keys[:, 0] != COO_PAD_KEY] if keys.size else keys
        nnz = int(live.shape[0])
        distinct = tuple(
            int(np.unique(live[:, j]).size) if nnz else 0
            for j in range(rel.key_arity)
        )
        size = 1
        for e in rel.extents:
            size *= int(e)
        hist = tuple(
            column_hist(live[:, j], int(rel.extents[j]))
            for j in range(rel.key_arity)
        )
        return RelationStats(
            distinct=distinct,
            extents=tuple(int(e) for e in rel.extents),
            nnz=nnz,
            density=(nnz / size) if size else 0.0,
            hist=hist,
        )
    raise TypeError(f"measure_stats: not a relation: {type(rel)}")


def relation_device(rel) -> torch.device:
    """The device a relation's payload lies on."""
    return rel.data.device if isinstance(rel, DenseRelation) else rel.values.device


def to_device(rel, device) -> "DenseRelation | CooRelation":
    """The relation with its tensors on ``device`` (the same object when
    they are there already)."""
    device = torch.device(device)
    if relation_device(rel) == device and (
        isinstance(rel, DenseRelation) or rel.keys.device == device
    ):
        return rel
    if isinstance(rel, DenseRelation):
        return DenseRelation(rel.data.to(device), rel.key_arity)
    return CooRelation(
        rel.keys.to(device), rel.values.to(device), rel.extents,
        rel.owner_dim, rel.shard_offsets,
    )
