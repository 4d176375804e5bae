"""Mesh construction over ``torch.distributed`` — the canonical mesh entry
points of the port.

``make_host_mesh`` / ``make_production_mesh`` build the (data × model)
``DeviceMesh``es the distribution planner (core/planner.py) reads its
geometry from; ``resolve_mesh`` turns the spec strings accepted by
``repro_torch.Database(mesh=...)`` into those meshes. A mesh spans the
ranks of the default process group, one rank per mesh position, so the
group must be initialised first: by the caller's launcher, by
``init_ranks`` in a process of its own, or by ``start_ranks``, which
starts N processes and initialises their group. The backend and each
rank's device are always the caller's choice: nothing here picks NCCL or
gloo, or moves a rank to the CPU, on its own.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.planner import DATA_AXIS_NAMES

def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _init_mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh spans the ranks of the default process group, and none "
            "is initialised: start the ranks with launch.mesh.start_ranks "
            "(or init_ranks in each process) first"
        )
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16×16 = 256 ranks; multi-pod adds a leading pod=2 axis (512 ranks)
    used for data parallelism. Raises unless the process group has exactly
    that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for s in shape:
        need *= s
    if _world() != need:
        raise ValueError(
            f"make_production_mesh: the {'multi-pod ' if multi_pod else ''}"
            f"production mesh {shape} needs {need} ranks; the process group "
            f"has {_world()}"
        )
    return _init_mesh(device_type, shape, axes)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda"):
    """Small (data × model) mesh over the ranks of the process group (a
    4-rank group gives a 2×2 mesh at ``model=2``). With a single rank this
    is a 1-axis ``("model",)`` mesh — the planner then reproduces its 1-D
    plans — instead of a degenerate (1, 1) mesh."""
    if model < 1:
        raise ValueError(f"make_host_mesh: model={model} must be >= 1")
    n = _world()
    if n == 1 and model == 1:
        return _init_mesh(device_type, (1,), ("model",))
    if n % model != 0:
        raise ValueError(
            f"make_host_mesh: {n} visible device(s) not divisible by "
            f"model={model}"
        )
    return _init_mesh(device_type, (n // model, model), ("data", "model"))


def resolve_mesh(spec, *, device_type: str = "cuda"):
    """Resolve a mesh spec to a DeviceMesh: None and mesh objects pass
    through; the strings ``"host"``, ``"host:<model>"``, ``"production"``
    and ``"production:multipod"`` name the standard meshes above, on
    ``device_type``'s devices."""
    if spec is None or not isinstance(spec, str):
        return spec
    name, _, arg = spec.partition(":")
    if name == "host":
        return make_host_mesh(model=int(arg) if arg else 1, device_type=device_type)
    if name == "production":
        if arg and arg not in ("multipod", "multi_pod", "2"):
            raise ValueError(
                f"unknown production mesh variant {arg!r}; use "
                "'production' or 'production:multipod'"
            )
        return make_production_mesh(multi_pod=bool(arg), device_type=device_type)
    raise ValueError(
        f"unknown mesh spec {spec!r}; use 'host[:<model>]' or "
        "'production[:multipod]'"
    )


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a DeviceMesh."""
    names = tuple(mesh.mesh_dim_names or ())
    return dict(zip(names, tuple(mesh.mesh.shape)))


def batch_axes(mesh) -> tuple:
    """Mesh axes used for data parallelism — the fold the planner
    (``core.planner.DATA_AXIS_NAMES``) puts on batch dimensions."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in DATA_AXIS_NAMES if a in names)


def data_parallel_size(mesh) -> int:
    """Total data-parallel ways: the product of the batch axes' sizes."""
    sizes = mesh_sizes(mesh)
    n = 1
    for a in batch_axes(mesh):
        n *= int(sizes[a])
    return n


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------


def init_ranks(backend: str, rank: int, world_size: int, store_path: str, *,
               device: Optional[torch.device] = None) -> None:
    """Initialise this process's default group: ``backend`` ("nccl",
    "gloo") over a ``FileStore`` at ``store_path`` shared by the
    ``world_size`` ranks. ``device`` is this rank's device: a CUDA device
    is made current, and on the CPU the rank takes one thread so that
    ranks sharing a host do not oversubscribe its cores."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    elif device is not None:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend,
        store=dist.FileStore(store_path, world_size),
        rank=rank,
        world_size=world_size,
    )


def _rank_entry(rank, fn, world_size, backend, device, store_path, out_dir, args):
    init_ranks(backend, rank, world_size, store_path, device=device)
    try:
        result = fn(rank, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start_ranks(fn: Callable, nprocs: int, *, backend: str, device, args: Sequence = ()) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``nprocs`` new processes (started with
    ``spawn``), each a rank of one process group on ``backend`` whose
    device is ``device`` (every rank's, e.g. "cuda:0" for ranks that share
    one card, or "cpu"). Returns each rank's return value (saved with
    ``torch.save``), in rank order; raises when a rank raises. ``fn`` must
    be importable by name in a new process. The store and the results
    live in a temporary directory that is removed at the end."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        mp.start_processes(
            _rank_entry,
            args=(fn, nprocs, backend, str(device), os.path.join(tmp, "store"), tmp, tuple(args)),
            nprocs=nprocs,
            start_method="spawn",
        )
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(nprocs)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
