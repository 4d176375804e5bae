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


def from_blocked(x, block_shape: Tuple[int, ...]) -> DenseRelation:
    """Split a dense tensor into a chunked DenseRelation (paper Fig 1): a
    grid of ``block_shape`` blocks, keyed by block index."""
    x = torch.as_tensor(x)
    if x.dim() != len(block_shape):
        raise ValueError(
            f"from_blocked: {x.dim()}-d tensor, {len(block_shape)}-d block shape"
        )
    grid = []
    for n, b in zip(x.shape, block_shape):
        if n % b:
            raise ValueError(f"from_blocked: extent {n} is not a multiple of block {b}")
        grid.append(n // b)
    # (g0,b0,g1,b1,...) -> (g0,g1,...,b0,b1,...)
    shape = []
    for g, b in zip(grid, block_shape):
        shape += [g, b]
    y = x.reshape(shape)
    perm = list(range(0, 2 * len(grid), 2)) + list(range(1, 2 * len(grid), 2))
    return DenseRelation(y.permute(perm).contiguous(), key_arity=len(grid))


def to_blocked(rel: DenseRelation) -> torch.Tensor:
    """Inverse of from_blocked: reassemble the dense tensor."""
    d = rel.key_arity
    grid = rel.extents
    block = rel.chunk_shape
    if len(block) != d:
        raise ValueError("to_blocked requires chunk_rank == key_arity")
    perm = [None] * (2 * d)
    for i in range(d):
        perm[2 * i] = i
        perm[2 * i + 1] = d + i
    y = rel.data.permute(perm)
    return y.reshape(tuple(g * b for g, b in zip(grid, block)))


# ---------------------------------------------------------------------------
# Chunk manifests: the host-resident blocked layout for out-of-core waves
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChunkManifest:
    """Row-blocking of one relation for out-of-core execution.

    ``axis`` is the blocked dimension — a key dim for a DenseRelation, and
    always the physical nnz row axis for a CooRelation. ``boundaries`` is
    the monotone cut vector (num_chunks+1 entries, first 0, last the row
    count), so chunk ``w`` is rows ``[boundaries[w], boundaries[w+1])``.
    ``owner_aligned`` records that COO cuts were snapped to owner-run
    starts (see ``make_manifest``): no Σ segment then straddles a wave, so
    each wave's partial segment grid is exact where touched and the
    ⊕-unit elsewhere — what lets zero-preserving kernels stream."""

    axis: int
    boundaries: Tuple[int, ...]
    owner_aligned: bool = False

    @property
    def num_chunks(self) -> int:
        return len(self.boundaries) - 1

    def chunk_rows(self, w: int) -> int:
        return self.boundaries[w + 1] - self.boundaries[w]

    @property
    def max_rows(self) -> int:
        return max(self.chunk_rows(w) for w in range(self.num_chunks))


def _run_start(owners: torch.Tensor, row: int) -> int:
    """The first row of the contiguous run of equal owners that holds
    ``row``: the last row r <= ``row`` with r == 0 or owners[r] !=
    owners[r - 1], searched in windows before ``row`` (1,024 rows, then
    doubling) until one holds a change of owner."""
    hi, window = row, 1024
    while hi > 0:
        lo = max(0, hi - window)
        part = owners[lo:hi + 1]
        change = torch.nonzero(part[1:] != part[:-1])
        if change.numel():
            return lo + int(change[-1, 0]) + 1
        hi, window = lo, 2 * window
    return 0


def make_manifest(rel, num_chunks: int, axis: int = 0) -> ChunkManifest:
    """Block ``rel`` into ``num_chunks`` row ranges.

    Dense relations split a key dim evenly (remainder spread over the
    leading chunks). COO relations split the nnz axis; when the relation
    is owner-partitioned, tentative even cuts are snapped *down* to the
    start of the owner run they fall into, so one Σ segment is never split
    across two waves (duplicate cuts collapse — heavy owners can reduce
    the chunk count). Each cut's run start is found on the relation's own
    device in a window of rows before the cut (``_run_start``), so a host
    relation of many rows is not scanned whole on every step."""
    if num_chunks < 1:
        raise ValueError(f"make_manifest: num_chunks={num_chunks} must be >= 1")
    if isinstance(rel, DenseRelation):
        if not 0 <= axis < rel.key_arity:
            raise ValueError(
                f"make_manifest: axis {axis} out of range for key arity "
                f"{rel.key_arity}"
            )
        rows = int(rel.extents[axis])
    elif isinstance(rel, CooRelation):
        axis = 0
        rows = rel.nnz
    else:
        raise TypeError(f"make_manifest: not a relation: {type(rel)}")
    if num_chunks > max(rows, 1):
        raise ValueError(
            f"make_manifest: {num_chunks} chunks over {rows} rows"
        )
    base, rem = divmod(rows, num_chunks)
    cuts = [0]
    for w in range(num_chunks):
        cuts.append(cuts[-1] + base + (1 if w < rem else 0))
    owner_aligned = False
    if isinstance(rel, CooRelation) and rel.owner_dim is not None and rows:
        # in the owner-sorted live region runs ARE owner groups, and the
        # trailing COO_PAD_KEY pad rows form one final run of their own
        # (splitting pads is harmless)
        owners = rel.keys[:, rel.owner_dim]
        snapped = [0]
        for c in cuts[1:-1]:
            s = _run_start(owners, c)
            if s > snapped[-1]:
                snapped.append(s)
        snapped.append(rows)
        cuts = snapped
        owner_aligned = True
    return ChunkManifest(axis, tuple(cuts), owner_aligned)


def split_chunks(rel, manifest: ChunkManifest):
    """Materialize the manifest's chunks as host-resident relations (CPU
    tensors, each contiguous — this is the spill step, not one of the
    step's own)."""
    rel = to_device(rel, "cpu")
    out = []
    for w in range(manifest.num_chunks):
        lo, rows = manifest.boundaries[w], manifest.chunk_rows(w)
        if isinstance(rel, DenseRelation):
            data = rel.data.narrow(manifest.axis, lo, rows).contiguous()
            out.append(DenseRelation(data, rel.key_arity))
        else:
            out.append(
                CooRelation(
                    rel.keys[lo:lo + rows].contiguous(),
                    rel.values[lo:lo + rows].contiguous(),
                    rel.extents,
                    rel.owner_dim,
                    None,
                )
            )
    return out


def assemble_chunks(chunks, manifest: ChunkManifest):
    """Inverse of ``split_chunks``: reassemble one relation on the host."""
    if not chunks:
        raise ValueError("assemble_chunks: no chunks")
    first = chunks[0]
    if isinstance(first, DenseRelation):
        data = torch.cat([c.data.cpu() for c in chunks], dim=manifest.axis)
        return DenseRelation(data, first.key_arity)
    keys = torch.cat([c.keys.cpu() for c in chunks], dim=0)
    values = torch.cat([c.values.cpu() for c in chunks], dim=0)
    return CooRelation(keys, values, first.extents, first.owner_dim, None)


def rechunk(chunks, old: ChunkManifest, new: ChunkManifest):
    """Re-block a chunked relation from manifest ``old`` to ``new`` —
    the same all-to-all ``split ∘ assemble`` whether the target is a
    different grid or a different tier. Round-tripping A→B→A is
    bit-stable (pure row movement, no arithmetic)."""
    if old.boundaries[-1] != new.boundaries[-1]:
        raise ValueError(
            f"rechunk: row counts differ ({old.boundaries[-1]} vs "
            f"{new.boundaries[-1]})"
        )
    if old.axis != new.axis:
        raise ValueError(f"rechunk: axes differ ({old.axis} vs {new.axis})")
    return split_chunks(assemble_chunks(chunks, old), new)


def owner_partition(
    rel: CooRelation, num_shards: int, dim: int = -1
) -> CooRelation:
    """Owner-partitioned nnz layout: sort rows by the key column ``dim``
    (the Σ's segment key — a GCN edge's dst node), pad nnz to a multiple
    of ``num_shards``, and record per-shard segment offsets.

    Each equal shard of the sorted rows then holds a contiguous owner-key
    range (``shard_offsets[s]`` is the first owner key of shard ``s``; a
    shard whose rows are all padding owns no segments and records the
    one-past-the-end owner extent). The out-of-core planner cuts waves at
    owner-run starts of this layout (``make_manifest``). The stable sort
    runs on the relation's own device and gives the reference's row order
    exactly (a stable sort's permutation is unique)."""
    if num_shards < 1:
        raise ValueError(f"owner_partition: num_shards={num_shards} must be >= 1")
    dim = dim % rel.key_arity
    order = torch.sort(rel.keys[:, dim], stable=True).indices
    keys, values = rel.keys[order], rel.values[order]
    sorted_rel = CooRelation(keys, values, rel.extents, owner_dim=dim)
    padded_nnz = ((sorted_rel.nnz + num_shards - 1) // num_shards) * num_shards
    sorted_rel = pad_coo_nnz(sorted_rel, padded_nnz)
    per = padded_nnz // num_shards
    firsts = [s * per for s in range(num_shards) if s * per < rel.nnz]
    owners = keys[firsts, dim].tolist() if firsts else []
    end = int(rel.extents[dim])  # empty-shard sentinel: one past the last owner
    offsets = tuple(
        int(owners[s]) if s < len(owners) else end for s in range(num_shards)
    )
    return CooRelation(
        sorted_rel.keys,
        sorted_rel.values,
        rel.extents,
        owner_dim=dim,
        shard_offsets=offsets,
    )
