"""Host-resident chunked backing store for out-of-core execution.

A ``ChunkStore`` holds relations that do not fit the session's device
memory budget as **host chunks** (CPU tensors) under a
``relation.ChunkManifest`` (the "different tier" generalization of
plan-aware rechunking: spilling to host is the same split/assemble
all-to-all as re-blocking to another grid, with a transfer instead of a
shuffle as its cost). The streaming executor (``core/engine.StreamedCompiled``)
fetches one chunk *wave* at a time.

On a CUDA store every chunk is kept in **pinned** host memory and ``fetch``
issues its host→device copy with ``non_blocking=True`` on the store's own
copy stream, recording an event behind it: the copy runs while the compute
stream works on the previous wave, which is the double buffer. The fetched
tensors are not ready until ``Fetched.wait`` has made the consuming stream
wait on that event (reading them earlier reads memory the copy has not
filled yet: a wrong answer, not an error). ``wait`` also records the
consuming stream on the tensors, so that the caching allocator does not
hand their memory to the copy stream's next allocation while a wave still
reads them. On a CPU store nothing is pinned (``pin_memory`` needs CUDA)
and a fetch is the host chunk itself.

Counters (the session's spill counters, exposed as
``Database.counters()["spill"]``):

    spilled_relations — relations currently backed by the store
    spilled_bytes     — host bytes across all stored chunks
    fetched_chunks    — chunk fetches issued (host→device transfers)
    fetched_bytes     — bytes moved host→device by those fetches
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import torch

from .relation import (
    ChunkManifest,
    CooRelation,
    DenseRelation,
    make_manifest,
    split_chunks,
)

AnyRel = Union[DenseRelation, CooRelation]


class OutOfCoreError(RuntimeError):
    """A memory-budgeted plan cannot be executed: the budget is too small
    for the resident relations, or the query's shape cannot stream (the
    reason names the offending node/relation)."""


def _tensors(rel: AnyRel) -> List[torch.Tensor]:
    return [rel.data] if isinstance(rel, DenseRelation) else [rel.keys, rel.values]


def _host_bytes(rel: AnyRel) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(rel))


def _with_tensors(rel: AnyRel, tensors: List[torch.Tensor]) -> AnyRel:
    if isinstance(rel, DenseRelation):
        return DenseRelation(tensors[0], rel.key_arity)
    return CooRelation(
        tensors[0], tensors[1], rel.extents, rel.owner_dim, rel.shard_offsets
    )


@dataclass(frozen=True)
class Fetched:
    """A chunk on its way to the device: ``relation`` holds the device
    tensors, ``event`` marks the end of their copy (None on the CPU, where
    nothing is copied)."""

    relation: AnyRel
    event: Optional["torch.cuda.Event"] = None

    def wait(self) -> AnyRel:
        """The relation, safe to read on the current stream: the stream
        waits for the copy, and the tensors are marked as in use on it."""
        if self.event is None:
            return self.relation
        stream = torch.cuda.current_stream()
        stream.wait_event(self.event)
        for t in _tensors(self.relation):
            t.record_stream(stream)
        return self.relation


class ChunkStore:
    """Named host-resident chunked relations + spill/fetch counters, for
    fetches to ``device`` (a CUDA store pins its chunks and copies them on
    a stream of its own)."""

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ChunkStore: a CUDA store needs a CUDA device and none is "
                "available; pass device='cpu'"
            )
        self._chunks: Dict[str, List[AnyRel]] = {}
        self._manifests: Dict[str, ChunkManifest] = {}
        self._copy_stream: Optional["torch.cuda.Stream"] = None
        self.stats: Dict[str, int] = {
            "spilled_relations": 0,
            "spilled_bytes": 0,
            "fetched_chunks": 0,
            "fetched_bytes": 0,
        }

    def __contains__(self, name: str) -> bool:
        return name in self._chunks

    def manifest(self, name: str) -> ChunkManifest:
        return self._manifests[name]

    def spill(self, name: str, rel: AnyRel, chunking, axis: int = 0) -> ChunkManifest:
        """Split ``rel`` into host chunks. ``chunking`` is either a chunk
        count (a fresh even manifest is built) or a ``ChunkManifest`` to
        reuse — co-streamed relations share the stream's cut boundaries on
        their own axis. Re-spilling a name under the same manifest is a
        no-op (a ``Database`` drops a name from its store whenever the name
        is ``put`` or dropped, so the chunks never outlive their data); a
        different manifest replaces its chunks."""
        if isinstance(chunking, ChunkManifest):
            manifest = chunking
        else:
            manifest = make_manifest(rel, int(chunking), axis=axis)
        if name in self._chunks and self._manifests[name] == manifest:
            return manifest
        chunks = split_chunks(rel, manifest)
        if self.device.type == "cuda":
            chunks = [
                _with_tensors(c, [t.pin_memory() for t in _tensors(c)])
                for c in chunks
            ]
        if name in self._chunks:
            self.drop(name)
        self._chunks[name] = chunks
        self._manifests[name] = manifest
        self.stats["spilled_relations"] += 1
        self.stats["spilled_bytes"] += sum(_host_bytes(c) for c in chunks)
        return manifest

    def fetch(self, name: str, w: int) -> Fetched:
        """Chunk ``w`` on the store's device. On CUDA the copy is issued
        on the copy stream and is still in flight: call ahead of use to
        overlap it with compute, and read the relation through
        ``Fetched.wait`` on the stream that consumes it."""
        chunk = self._chunks[name][w]
        self.stats["fetched_chunks"] += 1
        self.stats["fetched_bytes"] += _host_bytes(chunk)
        if self.device.type != "cuda":
            return Fetched(chunk)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        # the copy allocates on the copy stream; memory a wave freed is
        # handed to it only after the wave's stream is done with it
        # (``Fetched.wait`` recorded that stream on the wave's tensors)
        with torch.cuda.stream(self._copy_stream):
            moved = [t.to(self.device, non_blocking=True) for t in _tensors(chunk)]
            event = torch.cuda.Event()
            event.record(self._copy_stream)
        return Fetched(_with_tensors(chunk, moved), event)

    def host_chunk(self, name: str, w: int) -> AnyRel:
        """The raw host chunk (no transfer, no counter)."""
        return self._chunks[name][w]

    def clear(self) -> None:
        """Drop every relation's chunks; on a CUDA store also hand the
        pinned blocks they were staged in back to the system (PyTorch's
        pinned allocator caches a freed block for reuse, so ranks that
        share a host would otherwise keep each other's memory)."""
        for name in list(self._chunks):
            self.drop(name)
        if self.device.type == "cuda":
            # the pinned allocator's emptyCache binding (absent from some
            # builds: the blocks then stay cached for this process)
            empty = getattr(torch._C, "_host_emptyCache", None)
            if empty is not None:
                empty()

    def drop(self, name: str) -> None:
        chunks = self._chunks.pop(name, None)
        self._manifests.pop(name, None)
        if chunks is not None:
            self.stats["spilled_relations"] -= 1
            self.stats["spilled_bytes"] -= sum(_host_bytes(c) for c in chunks)
