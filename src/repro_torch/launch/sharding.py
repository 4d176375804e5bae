"""Sharding assignment on a mesh — the counterpart of the reference's
``launch/sharding.py`` — and the placement of a language model's
parameters, activations and caches on a ``torch.distributed`` mesh.

The rules are the reference's, decision for decision:

  * tensor parallelism ("model" axis): every parameter matrix's output
    feature / expert / channel dimension, per the rule table below;
  * fully sharded data parallelism ("data"): the largest remaining
    divisible dimension of every parameter of at least 1 MiB (its element
    count × 4, whatever the dtype; ties to the lowest dimension), gathered
    at use, one layer at a time;
  * batch axes carry activations; a batch of one shards the KV cache's
    sequence dimension over "data" instead (``cache_pspecs``).

The reference stacks a stage's repeated superblocks on a leading axis and
tests ``"/scan/" in path`` to skip it; the port keeps one parameter per
repeat (``convert.reference_leaf`` maps a name to the reference's leaf).
A port leaf's spec is the reference's spec for the stacked leaf with that
leading entry dropped, and the 1 MiB threshold is taken on the stacked
shape, all of a stage's repeats, as the reference takes it.

XLA's partitioner places the reference's collectives; the port has none,
so a ``Placement`` runs its model explicitly: each rank holds its shards
(``shard``, or a model built on the mesh), computes on them, and calls
the collectives of ``launch/collectives.py`` where the partitioner would
put them (``models/``: the attention (full, windowed, cross or MLA) and
MLP column- then row-parallel, the experts split over the model ranks, the
SSM layers on the rank's channels or heads with the scan local, the
vocabulary-parallel embedding and head, tied or not, whisper's encoder
whole on every rank, the FSDP gathers; ``train/trainer.py``: the
data-parallel gradient sums, over "pod" too, and the global norm). A
mesh's specs are given as ``P`` (``core/planner.py``); ``to_shardings``
turns them into DTensor placements.

The SSM layers' ``in_proj`` (and ``mamba2``'s conv) concatenate segments
on the dimension the rules put on "model"; a rank's shard there is its
slice of each segment (``segment_widths``, ``shard_index``), not the
spec's contiguous block, which would hand one rank all of x and another
all of z (ROADMAP.md §3).
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.planner import DATA_AXIS_NAMES, MeshGeometry, P, fold_axes

# name-based rules: which dimension gets the tensor-parallel axis.
# value = index of the dim to place on "model" (negative ok), or None.
_MODEL_DIM_RULES = (
    ("router", None),
    ("q_norm", None),
    ("k_norm", None),
    ("kv_norm", None),
    ("norm_scale", None),
    ("wq_a", 1),
    ("wq_b", 1),
    ("wkv_a", None),
    ("wk_b", 1),
    ("wv_b", 1),
    ("wi_gate", -1),
    ("wi_up", -1),
    ("wo", 0),        # row-parallel: contraction dim sharded -> psum
    ("wq", 1),
    ("wk", 1),
    ("wv", 1),
    ("in_proj", 1),
    ("out_proj", 0),
    ("x_proj", 0),
    ("dt_proj", 1),
    ("conv_w", 1),
    ("conv_b", 0),
    ("dt_bias", 0),
    ("a_log", 0),
    ("d_skip", 0),
    ("out_embed", 1),
    ("embed", 0),     # vocab-parallel embedding table
)

_MOE_3D = ("wi_gate", "wi_up", "wo")  # (E, ·, ·): experts on "model"

DP = ("pod", "data")  # batch axes superset; hint() drops absent names

#: the block kinds a ``Placement`` runs on a mesh: all of ``models.blocks.KINDS``
MESH_KINDS = ("attn", "moe", "local", "global", "mla", "mla_moe", "mamba1", "mamba2",
              "mamba2_attn", "enc", "dec")


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a planner
    ``MeshGeometry`` (whose data axes, when there are several, are folded
    and so cannot be told apart: pass a mapping for those), or a mapping
    of axis names to sizes."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if isinstance(mesh, MeshGeometry):
        if len(mesh.data_axes) > 1:
            raise ValueError(
                f"{mesh} folds the data axes {mesh.data_axes}; pass their sizes as a mapping "
                "{axis: size}"
            )
        out = dict.fromkeys(mesh.data_axes, mesh.data_size)
        out[mesh.model_axis] = mesh.model_size
        return out
    names = tuple(mesh.mesh_dim_names or ())
    return dict(zip(names, (int(s) for s in mesh.mesh.shape)))


def _leaf_name(name: str) -> str:
    return name.replace("/", ".").rsplit(".", 1)[-1]


def param_pspec(
    name: str,
    shape: Tuple[int, ...],
    *,
    model_size: int,
    fsdp_axes: Tuple[str, ...],
    fsdp_size: int,
    min_fsdp_bytes: int = 1 << 20,
    stacked: bool,
) -> P:
    """PartitionSpec for one parameter leaf, by its name (the last
    component decides). ``stacked`` marks a stage leaf whose dim 0 is the
    layer axis (never sharded)."""
    name = _leaf_name(name)
    off = 1 if stacked else 0
    ndim = len(shape)
    spec: list = [None] * ndim

    model_dim = None
    is_moe = name in _MOE_3D and (ndim - off) == 3
    if is_moe:
        model_dim = off  # expert axis
    else:
        for key, rule in _MODEL_DIM_RULES:
            if name == key:
                if rule is not None:
                    # a negative rule counts from the end, stacked or not
                    model_dim = rule + off if rule >= 0 else ndim + rule
                break
    if model_dim is not None and shape[model_dim] % model_size == 0:
        spec[model_dim] = "model"

    # FSDP: largest remaining divisible dim (ties to the lowest), if the
    # leaf is big enough — counted at 4 bytes an element, whatever the dtype
    nbytes = math.prod(shape) * 4
    if fsdp_axes and nbytes >= min_fsdp_bytes:
        cands = [d for d in range(off, ndim) if spec[d] is None and shape[d] % fsdp_size == 0]
        if cands:
            d = max(cands, key=lambda i: shape[i])
            spec[d] = fsdp_axes if len(fsdp_axes) > 1 else fsdp_axes[0]
    return P(*spec)


def _shapes(params) -> Dict[str, Tuple[int, ...]]:
    """name → shape of a model (its ``named_parameters()``) or a mapping
    of names to tensors or shapes."""
    if hasattr(params, "named_parameters"):
        params = dict(params.named_parameters())
    return {k: tuple(getattr(v, "shape", v)) for k, v in params.items()}


def param_pspecs(params, mesh, *, fsdp: bool = True) -> Dict[str, P]:
    """name → PartitionSpec for a model's parameters (a ``Model``, or a
    mapping of ``named_parameters()`` names to tensors or shapes, e.g. of a
    model on the ``meta`` device). Each leaf gets the reference's spec for
    its leaf in the reference's tree (``convert.reference_leaf``): a
    stage's repeats are stacked on a leading axis for the rules and the
    1 MiB threshold, and that axis's entry is dropped."""
    from repro_torch.convert import reference_leaf

    shapes = _shapes(params)
    sizes = axis_sizes(mesh)
    model_size = sizes["model"]
    dp_axes = tuple(a for a in ("data",) if a in sizes)
    fsdp_size = sizes.get("data", 1) if fsdp else 1
    where = {name: reference_leaf(name) for name in shapes}
    repeats: Dict[str, int] = {}
    for path, r, _ in where.values():
        if r is not None:
            repeats[path] = max(repeats.get(path, 0), r + 1)
    out = {}
    for name, shape in shapes.items():
        path, r, stacked = where[name]
        full = shape if r is None else (repeats[path],) + shape
        spec = param_pspec(path, full, model_size=model_size,
                           fsdp_axes=dp_axes if fsdp else (), fsdp_size=fsdp_size, stacked=stacked)
        out[name] = spec if r is None else P(*spec[1:])
    return out


def batch_pspecs(batch, mesh) -> Dict[str, P]:
    """Input batch: batch dimension over the mesh's data axes (the same
    ("pod", "data") fold the relational planner emits)."""
    sizes = axis_sizes(mesh)
    bspec = fold_axes(tuple(a for a in DATA_AXIS_NAMES if a in sizes))
    return {k: P() if len(_dims(v)) == 0 else P(bspec, *([None] * (len(_dims(v)) - 1)))
            for k, v in batch.items()}


def _dims(v) -> Tuple[int, ...]:
    return tuple(getattr(v, "shape", v))


def cache_pspecs(caches, mesh, *, batch: int, seq_sharded: bool):
    """KV/SSM cache sharding for serving, in the port's cache layout (a
    list per stage of ``{"scan": [entry per repeat], "tail": [...]}``, the
    batch on axis 0 of every leaf).

    batch ≥ data-axis: batch dim over "data", kv-heads/channels on "model".
    batch == 1 (long_500k): the cache *sequence* dim over "data". As in the
    reference, a dimension is split where its extent divides by 16, not by
    the mesh's sizes (the reference's production axes). Leaf layouts:
       k/v   (B, S, Hkv, hd)     c/r (B, S, dc)
       conv  (B, W-1, C)         ssm (B, C, N) | (B, H, N, P)
    """
    del mesh, batch
    data = "data"

    def assign(name, shape):
        spec = [None] * len(shape)
        if not seq_sharded:
            spec[0] = data        # batch dim
        if name in ("k", "v"):
            if seq_sharded and shape[1] % 16 == 0:
                spec[1] = data
            if shape[2] % 16 == 0:
                spec[2] = "model"
        elif name in ("c", "r"):
            if seq_sharded and shape[1] % 16 == 0:
                spec[1] = data
        elif name == "conv":
            if shape[2] % 16 == 0:
                spec[2] = "model"
        elif name == "ssm":
            if shape[1] % 16 == 0:
                spec[1] = "model"
        return P(*spec)

    def walk(node, name=""):
        if isinstance(node, Mapping):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, name) for v in node)
        return assign(name, _dims(node))

    return walk(caches)


def coo_pspecs(rel, mesh):
    """CooRelation-shaped spec for the nnz-sharded edge layout: keys'
    and values' row (nnz) dim over the mesh's batch axes — the fold the
    relational planner emits for ``data:shard_nnz_*`` plans."""
    from repro_torch.core.relation import CooRelation

    sizes = axis_sizes(mesh)
    row = fold_axes(tuple(a for a in DATA_AXIS_NAMES if a in sizes))
    return CooRelation(P(row, None), P(row, *([None] * (rel.values.dim() - 1))),
                       rel.extents, rel.owner_dim, rel.shard_offsets)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, and the DTensor placements it means: per mesh
    dimension ``Shard(d)`` where the spec names that axis on tensor dim
    ``d`` (a folded tuple shards the one dim over each of its axes, in
    order), else ``Replicate()``."""

    mesh: Any
    spec: P
    placements: Tuple[Any, ...]


def to_shardings(pspecs, mesh):
    """A spec (or a tree of them: dicts, lists) as ``NamedSharding``s on
    ``mesh``, a DeviceMesh."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())

    def one(spec):
        placements = []
        for axis in names:
            dims = [d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            placements.append(Shard(dims[0]) if dims else Replicate())
        return NamedSharding(mesh, spec, tuple(placements))

    def walk(node):
        if isinstance(node, P):
            return one(node)
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(pspecs)


def catalog_shardings(db, mesh=None) -> Dict[str, NamedSharding]:
    """``NamedSharding`` per catalog relation of ``db`` whose layout a
    compiled plan committed it to (``Database.layout``) — the placements
    to give freshly loaded inputs so that they arrive at the planned
    layout. ``mesh`` defaults to the session's; relations no plan placed
    yet are omitted."""
    mesh = mesh if mesh is not None else db.mesh
    if mesh is None:
        return {}
    return {name: to_shardings(db.layout(name), mesh)
            for name in sorted(db.catalog) if db.layout(name) is not None}


# ---------------------------------------------------------------------------
# A model on a mesh
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar[Optional["Placement"]] = contextvars.ContextVar(
    "repro_torch_placement", default=None)


def _group(entry, extent: int, sizes: Mapping[str, int], comm) -> Optional[str]:
    """The group of ``comm`` a spec entry names: "model"; the batch fold
    of the data axes present ("data", or "batch" where ``comm`` has a pod
    group apart); "data" or "pod" alone where ``comm`` has those apart; or
    None (axes absent from the mesh dropped; None where the group's size
    does not divide ``extent``, or where the entry names no group of
    ``comm``)."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    axes = tuple(a for a in axes if a is not None and a in sizes)
    if not axes:
        return None
    if axes == ("model",):
        kind = "model"
    elif axes == tuple(a for a in DATA_AXIS_NAMES if a in sizes):
        kind = "batch" if "batch" in comm.size else "data"
    elif "batch" in comm.size and axes in (("data",), ("pod",)):
        kind = axes[0]
    else:
        return None
    return kind if extent % comm.size[kind] == 0 else None


def _cut(t: torch.Tensor, spec, sizes: Mapping[str, int], comm) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` by ``spec``: a copy of
    its own where anything is cut (a view would keep the whole alive), else
    ``t``."""
    shard = t
    for d, e in enumerate(spec):
        kind = _group(e, t.shape[d], sizes, comm)
        if kind is not None:
            n = t.shape[d] // comm.size[kind]
            shard = shard.narrow(d, comm.index[kind] * n, n)
    return t if shard is t else shard.clone(memory_format=torch.contiguous_format)


def shard_index(widths: Sequence[int], m: int, r: int) -> torch.Tensor:
    """The positions, in a dimension that concatenates segments of
    ``widths``, of rank ``r``'s shard among ``m`` ranks that each own a
    slice of every segment: rank r's slice of each segment, in segment
    order."""
    out, off = [], 0
    for w in widths:
        n = w // m
        out.append(torch.arange(off + r * n, off + (r + 1) * n))
        off += w
    return torch.cat(out)


def hint(x: torch.Tensor, *spec, whole: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Make ``x``'s layout the one ``spec`` asks for on the active
    placement's mesh; off a mesh a no-op, as the reference's
    ``with_sharding_constraint`` hint. ``whole`` is ``x``'s shape on one
    device (default ``x.shape``: ``x`` is whole on every rank). A dim that
    ``spec`` puts on mesh axes is cut to the rank's slice where it is
    whole, and left where it already is the rank's slice; axis names
    absent from the mesh are dropped, and axes that do not divide the
    dimension, as in the reference."""
    place = _ACTIVE.get()
    if place is None:
        return x
    whole = tuple(x.shape) if whole is None else tuple(whole)
    for d, entry in enumerate(spec):
        kind = place.kind_of(entry, whole[d])
        if kind is None or place.size(kind) == 1:
            continue
        local = whole[d] // place.size(kind)
        if x.shape[d] == whole[d]:
            x = x.narrow(d, place.index(kind) * local, local)
        elif x.shape[d] != local:
            raise ValueError(f"hint: dim {d} of {tuple(x.shape)} is neither whole ({whole[d]}) "
                             f"nor the rank's slice ({local}) on {entry!r}")
    return x


def _block_kind(name: str, stages) -> Optional[str]:
    """The block kind of the layer parameter ``name`` belongs to (None
    outside the stages): a scan block's name carries it after the ":", a
    remainder layer's is its stage's ``tail`` entry."""
    parts = name.split(".")
    if parts[0] != "stages":
        return None
    if parts[2] == "scan":
        return parts[4].split(":", 1)[1]
    return stages[int(parts[1])].tail[int(parts[3])]


def segment_widths(cfg, name: str, kind: Optional[str]) -> Optional[Tuple[int, ...]]:
    """The segments that the model-axis dimension of parameter ``name`` (of
    a ``kind`` block) concatenates, each split over the model ranks on its
    own (None for a leaf split in one block): a ``mamba1`` layer's
    ``in_proj`` emits [x | z]; a ``mamba2`` layer's emits [z | x | B | C |
    dt], and its ``conv_w``/``conv_b`` convolve [x | B | C]. A rank owns
    its channels (heads) of x, z and dt and its slice of B and C."""
    leaf = _leaf_name(name)
    di = cfg.ssm_expand * cfg.d_model
    if kind == "mamba1" and leaf == "in_proj":
        return (di, di)
    if kind in ("mamba2", "mamba2_attn"):
        n = cfg.ssm_state
        if leaf == "in_proj":
            return (di, di, n, n, di // cfg.ssm_head_dim)
        if leaf in ("conv_w", "conv_b"):
            return (di, n, n)
    return None


class Placement:
    """A language model of ``cfg`` on ``mesh``: the specs of its
    parameters, this rank's coordinates, and the collectives its step
    calls. ``mesh`` is a DeviceMesh of the default process group's ranks
    (``("model",)``, ``("data", "model")`` or ``("pod", "data", "model")``),
    or a mapping of axis names to sizes, whose collectives are rank 0's
    shape-only ones (``collectives.ShapeComm``: a walk over ``meta``
    tensors, as ``launch/dryrun.py`` makes). Every block kind of the zoo is
    placed (``MESH_KINDS``: whisper's ``enc``/``dec`` layers too) and
    qwen2-vl's vision prefix. An SSM layer's channels, heads and state,
    and an MLA layer's heads and q latent, must split over the model ranks
    (else ``ValueError``, naming them); any other width that does not
    split stays whole on every model rank (``splits``).

    A "pod" axis carries data parallelism with "data": the batch is cut
    over the ("pod", "data") fold (the group ``batch`` names), FSDP shards
    over "data" alone, as the reference's ``param_pspecs`` does, and the
    gradients are summed over "pod" after the FSDP reduce-scatters over
    "data" (``sync_grads``).

    ``shard`` cuts the rank's shards of whole parameters; the model's
    entry points (``Model.prefill(..., place=)``) run on those within
    ``active()``, whose relational products run in a mesh-less twin of the
    ambient session: on local shards each product is the rank's own.

    The specs are the reference's. Where a leaf's model-axis dimension
    concatenates segments (``segment_widths``: the SSM layers' ``in_proj``
    and ``mamba2``'s conv), the rank's shard is its slice of each segment,
    not the spec's contiguous block: ``cut``, ``local_shape``, ``whole``
    and the FSDP ``gather_tree`` all follow that cut (ROADMAP.md §3)."""

    def __init__(self, cfg, mesh):
        from repro_torch.models.model import param_shapes, stages_of

        from .collectives import ShapeComm, comm_for

        sizes = axis_sizes(mesh)
        stages = stages_of(cfg)
        kinds = set()
        for st in stages:
            kinds |= set(st.pattern) | set(st.tail)
        # an SSM layer runs on its channels (heads) and its slice of the
        # state, an MLA layer on its heads and its slice of the q latent:
        # they must split over the model ranks
        di, need = cfg.ssm_expand * cfg.d_model, []
        if "mamba1" in kinds:
            need.append((di, "channels"))
        if kinds & {"mamba2", "mamba2_attn"}:
            need += [(di // cfg.ssm_head_dim, "SSM heads"), (cfg.ssm_state, "state columns")]
        if kinds & {"mla", "mla_moe"}:
            need += [(cfg.n_heads, "MLA heads"), (cfg.q_lora_rank, "q latent columns")]
        bad = [f"{n} {w}" for n, w in need if n % sizes.get("model", 1)]
        if bad:
            raise ValueError(f"{cfg.name} on a mesh: {', '.join(bad)} do not split over "
                             f"{sizes['model']} model ranks")
        self.cfg = cfg
        self.mesh = mesh
        self.sizes = sizes
        # FSDP and the data groups: "data" alone, the batch over the
        # ("pod", "data") fold (module docstring)
        geometry = MeshGeometry("model", sizes["model"], tuple(a for a in ("data",) if a in sizes),
                                sizes.get("data", 1))
        self.comm = (ShapeComm.of_sizes(sizes, geometry) if isinstance(mesh, Mapping)
                     else comm_for(mesh, geometry))
        #: the group the batch is cut over
        self.batch = "batch" if "batch" in self.comm.size else "data"
        self.shapes = param_shapes(cfg)
        # FSDP needs a "data" axis; a model-only mesh gets the tensor-parallel
        # rules, as the reference's steps ask for them
        self.specs = param_pspecs(self.shapes, sizes, fsdp="data" in sizes)
        # whisper's encoder runs whole on every rank (ROADMAP.md §3): the
        # reference's specs for its stacked leaves would split q/k/v by
        # their input rows and leave wo and the MLP whole
        for name, shape in self.shapes.items():
            if name.startswith("encoder."):
                self.specs[name] = P(*([None] * len(shape)))
        #: name → (dim, segment widths) of the leaves cut by segment
        self.segments: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
        for name, spec in self.specs.items():
            widths = segment_widths(cfg, name, _block_kind(name, stages))
            if widths is not None and "model" in spec:
                self.segments[name] = (tuple(spec).index("model"), widths)
        self._twins: Dict[int, Any] = {}

    # -- coordinates ---------------------------------------------------------

    def size(self, kind: str) -> int:
        return self.comm.size[kind]

    def index(self, kind: str) -> int:
        return self.comm.index[kind]

    def kind_of(self, entry, extent: int) -> Optional[str]:
        """"model", "data" or None: the group a spec entry names on this
        mesh (``_group``)."""
        return _group(entry, extent, self.sizes, self.comm)

    def splits(self, extent: int) -> bool:
        """Whether the model ranks split a dimension of ``extent`` (a rule's
        dimension: the heads' width, d_ff, the experts, the vocabulary)."""
        return self.size("model") > 1 and extent % self.size("model") == 0

    def sharded_kinds(self, name: str) -> Tuple[str, ...]:
        """The groups of more than one rank a parameter is split over."""
        return tuple(k for k in ("data", "model")
                     if self.size(k) > 1 and any(self.kind_of(e, 0) == k for e in self.specs[name]))

    # -- parameters ----------------------------------------------------------

    def local_shape(self, name: str) -> Tuple[int, ...]:
        return tuple(n // self.size(k) if (k := self.kind_of(e, n)) else n
                     for e, n in zip(self.specs[name], self.shapes[name]))

    def cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The rank's shard of parameter ``name``: ``t`` cut where it is
        whole, ``t`` itself where it already is the shard."""
        shape = tuple(t.shape)
        if shape == self.local_shape(name):
            return t
        if shape != self.shapes[name]:
            raise ValueError(f"{name}: shape {shape} is neither whole {self.shapes[name]} "
                             f"nor the rank's shard {self.local_shape(name)}")
        seg = self.segments.get(name)
        if seg is None or self.size("model") == 1:
            return _cut(t, self.specs[name], self.sizes, self.comm)
        dim, widths = seg
        idx = shard_index(widths, self.size("model"), self.index("model")).to(t.device)
        spec = tuple(None if d == dim else e for d, e in enumerate(self.specs[name]))
        return _cut(t.index_select(dim, idx), spec, self.sizes, self.comm)

    @torch.no_grad()
    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole parameter ``name`` from the ranks' shards of it (``t``
        the caller's; forward-only collectives, every rank calls it)."""
        m = self.size("model")
        for d, e in enumerate(self.specs[name]):
            kind = self.kind_of(e, self.shapes[name][d])
            if kind is None:
                continue
            t = self.comm.all_gather(t.contiguous(), d, kind)
            if kind == "model" and name in self.segments:
                order = torch.cat([shard_index(self.segments[name][1], m, r) for r in range(m)])
                t = t.index_select(d, torch.argsort(order).to(t.device))
        return t

    def shard(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``cut`` of every parameter of ``params`` (whole or the rank's)."""
        return {k: self.cut(k, v) for k, v in params.items()}

    def gather_tree(self, node, prefix: str):
        """A parameter subtree (``param_tree``'s dicts and lists under
        ``prefix``) with every leaf split over the data ranks gathered
        whole on that dim (FSDP: at use, one layer at a time; the gradient
        reduce-scattered)."""
        from .collectives import all_gather

        if isinstance(node, Mapping):
            return {k: self.gather_tree(v, f"{prefix}{k}.") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [self.gather_tree(v, f"{prefix}{i}.") for i, v in enumerate(node)]
        name = prefix[:-1]
        for d, e in enumerate(self.specs[name]):
            if self.kind_of(e, self.shapes[name][d]) == "data":
                node = all_gather(node, self.comm, d, "data")
        return node

    # -- gradients -----------------------------------------------------------

    @torch.no_grad()
    def sync_grads(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each rank's gradients summed over the data ranks where the
        parameter is not split over them (an FSDP leaf's gradient was
        reduce-scattered by its gather's backward), then, on a pod axis,
        every leaf's over the pods, which hold the same shards."""
        out = {k: g if "data" in self.sharded_kinds(k) else self.comm.all_reduce(g, "data")
               for k, g in grads.items()}
        if "pod" in self.comm.size:
            out = {k: self.comm.all_reduce(g, "pod") for k, g in out.items()}
        return out

    @torch.no_grad()
    def grad_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The global 2-norm of the whole gradient from the ranks' shards:
        each leaf's Σg² summed, in order, with the others split over the
        same groups, then each group's sums added over its ranks — a leaf
        replicated over a group counted once, not once per rank (the pods
        hold the same shards: nothing is added over "pod"). A leaf
        cut by segment is split all the same (each rank's shard is a
        disjoint part of it); a replicated leaf that a rank uses in part
        (``mamba2``'s ``norm_scale``) has its whole gradient on every rank
        already (``scatter_to``'s backward)."""
        parts = {kinds: 0 for kinds in ((), ("model",), ("data",), ("data", "model"))}
        for k, g in grads.items():
            kinds = self.sharded_kinds(k)
            parts[kinds] = parts[kinds] + torch.sum(g.float() ** 2)
        total = parts[()]
        for kinds in (("model",), ("data",), ("data", "model")):
            s = parts[kinds]
            if isinstance(s, int):
                continue
            for kind in kinds:
                s = self.comm.all_reduce(s, kind)
            total = total + s
        return torch.sqrt(total)

    # -- activations ---------------------------------------------------------

    def copy_to(self, t):
        from .collectives import copy_to

        return copy_to(t, self.comm, "model")

    def reduce(self, t):
        from .collectives import reduce_from

        return reduce_from(t, self.comm, "model")

    def gather_from(self, t, dim: int, kind: str = "model"):
        from .collectives import gather_from

        return gather_from(t, self.comm, dim, kind)

    def scatter_to(self, t, dim: int):
        from .collectives import scatter_to

        return scatter_to(t, self.comm, dim, "model")

    def psum(self, t):
        """Σ of the model ranks' partials, forward and backward: a sum that
        every rank uses whole while its own use gives only part of the
        sum's gradient (``mamba1``'s ``x_proj`` output, ``mamba2``'s gated
        norm's Σy²). ``reduce`` alone would keep each rank's part of the
        gradient only."""
        return self.copy_to(self.reduce(t))

    def gather_summed(self, t, dim: int):
        """The model ranks' slices of ``t`` concatenated on ``dim``; the
        gradient of the whole summed over the ranks and cut to the rank's
        slice backward (each rank's use gives a part of it: ``mamba2``'s B
        and C, which every head reads)."""
        from .collectives import all_gather

        return all_gather(t, self.comm, dim, "model")

    def all_reduce(self, t, kind: str):
        """A forward-only Σ over a group (metrics, counts)."""
        return self.comm.all_reduce(t, kind)

    def heads_local(self, cfg) -> bool:
        """Whether each rank attends over its own heads: the model ranks
        split q, k and v on head boundaries (else the projections are
        gathered whole and every rank attends over all heads)."""
        hd, m = cfg.hd(), self.size("model")
        return (self.splits(cfg.n_heads * hd) and self.splits(cfg.n_kv_heads * hd)
                and cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0)

    def kv_heads(self, cfg) -> int:
        """The KV heads in a rank's attention cache."""
        return cfg.n_kv_heads // self.size("model") if self.heads_local(cfg) else cfg.n_kv_heads

    # -- the step's context --------------------------------------------------

    def _twin(self, db):
        """``db`` if it has no mesh, else a mesh-less session on its device
        with its dispatch table (made once per session)."""
        if db._mesh_spec is None:
            return db
        twin = self._twins.get(id(db))
        if twin is None or twin[0] is not db:
            from repro_torch.core.session import Database

            twin = self._twins[id(db)] = (db, Database(
                db.device, dispatch=db.dispatch, rewrite=db.rewrite_rules,
                fuse_join_agg=db.fuse_join_agg))
        return twin[1]

    @contextlib.contextmanager
    def active(self):
        """Run a step of the model on this placement: ``hint`` and the
        blocks read it, and the relational products run in the mesh-less
        twin of the ambient session."""
        from repro_torch.core import session

        token = _ACTIVE.set(self)
        try:
            with self._twin(session.current()).activate():
                yield self
        finally:
            _ACTIVE.reset(token)

