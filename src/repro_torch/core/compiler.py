"""Chunked compiler: lowers FRA query graphs to PyTorch tensor operations.

This is the fast path of the engine. Where the sparse interpreter executes
tuple-at-a-time (the oracle), this executor lowers whole operators to
tensor ops over chunked relations:

  Σ(grp, +, ⋈(eq-pred, proj, mul/matmul, ·, ·)) over DenseRelations
      → one ``torch.einsum`` (block axes from the join's key-equivalence
        classes, chunk axes from the kernel's chunk_spec), or one 2-D
        matrix product when the contraction has that shape;
  joins against a CooRelation (graph edges)   → row gather;
  Σ over a CooRelation                        → segment sum (scatter-add);
  RJP broadcast/aligned joins (from Σ/σ differentiation)
      → permute + broadcast + elementwise kernel;
  σ                                           → select/permute/elementwise.

The three hardware hot-spots — the Σ over a CooRelation, the matmul-shaped
Σ∘⋈, and the COO gather join (edge ⋈ node, plus the restricted-join
sparse-gradient gather) — are not called directly: each lowering site is
resolved against the kernel dispatch registry (kernels.py), which routes
it to the CUDA kernels (kernels/segsum, kernels/gather, kernels/matmul),
their plain versions, or the plain torch lowering, according to the
``DispatchTable`` the engine threads through ``_execute_graph``. Resolved
tiers are recorded into the caller's ``resolutions`` dict (the engine
exposes them on ``Compiled.resolutions``). All gather/scatter sites honour
the COO pad-and-mask contract: negative (padding) key components gather
zero rows and are dropped by segment sums.

The walk also runs over relations whose tensors lie on the ``meta``
device — the engine's lowering walk, which records the dispatch decisions
and the output shapes without computing anything. There a dispatched site
takes the op's plain version, which only propagates shapes.

Keys are int32, as in the reference; they are widened to int64 only where
torch indexing requires it.

On a mesh, ``_execute_graph(..., place=Placement(...))`` runs the same
walk on one rank's local shards. A ``Placement`` knows the layout of every
value (``Layout``: which block dims — for a COO relation, the nnz rows, dim
0 — an axis group of the mesh shards) and the mesh's collective layer. A
planned Join first moves each operand to the layout its ``JoinPlan`` names
(an all-gather where a sharded dim must be whole, a local slice where a
whole one must be sharded); every join, planned or not, then runs on local
shards by one rule: an axis group shards at most one join-key class, every
operand holding that class is sliced alike, and the output is sharded where
the class survives the (Σ-composed) projection, or a partial sum per rank
where a Σ drops it. A gather against a sharded table looks each key up in
its own rows only (the other ranks' keys gather zero rows), leaving partial
sums too. A partial sum never outlives the node that made it: it is reduced
at once, by an all-reduce over the group — or, for the Σ-scatter of a
``data:shard_nnz_*`` plan, by a reduce-scatter whose rows stay sharded. The
kernels run on the local shards, and a step's outputs are made whole on
every rank.

Dense gradients of *absent* tuples: a relational gradient relation simply
lacks tuples that received no contribution; a dense tensor cannot express
absence, so the compiled gradient stores explicit zeros there. Under the
additive aggregation semantics this is exact.
"""

from __future__ import annotations

import math
import string
from typing import Dict, List, Optional, Tuple, Union

import torch

from . import fra, kernels
from .kernels import BinKernel
from .keys import JoinPred, JoinProj, KeyFn, L, Lit, R, join_equiv_classes
from .relation import CooRelation, DenseRelation

AnyRel = Union[DenseRelation, CooRelation]
Env = Dict[str, AnyRel]

#: where a value's tensors lie across the ranks: block dim (0 = the nnz
#: rows of a COO relation) → the axis group ("data" or "model") sharding
#: it; dims not named are whole on every rank
Layout = Dict[int, str]

_BLOCK_LETTERS = string.ascii_uppercase


def _vmapped(fn, times: int):
    """Kernel functions have chunk-local semantics (they see one tuple's
    value). Lift them over leading block-key / nnz axes with
    ``torch.func.vmap`` so shape-dependent kernels (e.g. sum_chunk) stay
    correct."""
    for _ in range(times):
        fn = torch.func.vmap(fn)
    return fn


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


class LoweringError(NotImplementedError):
    pass


def _norm_pairs(pred: JoinPred):
    """Normalize eq pairs into (L, R), (L, Lit), (R, Lit) canonical forms."""
    lr, llit, rlit = [], [], []
    for a, b in pred.eqs:
        pair = (a, b)
        if isinstance(b, L) or (isinstance(b, R) and isinstance(a, Lit)):
            pair = (b, a)
        a, b = pair
        if isinstance(a, L) and isinstance(b, R):
            lr.append((a.idx, b.idx))
        elif isinstance(a, R) and isinstance(b, L):
            lr.append((b.idx, a.idx))
        elif isinstance(a, L) and isinstance(b, Lit):
            llit.append((a.idx, b.val))
        elif isinstance(a, R) and isinstance(b, Lit):
            rlit.append((a.idx, b.val))
        elif isinstance(a, L) and isinstance(b, L):
            raise LoweringError(f"L-L equality {a}=={b} not lowerable")
        elif isinstance(a, R) and isinstance(b, R):
            raise LoweringError(f"R-R equality {a}=={b} not lowerable")
        else:
            raise LoweringError(f"cannot normalize predicate pair {a}=={b}")
    return lr, llit, rlit


# ---------------------------------------------------------------------------
# Dispatch helpers
# ---------------------------------------------------------------------------


def _note(
    resolutions: Optional[Dict], op: str, site: str, impl, info: Optional[Dict] = None
) -> None:
    """Record a dispatch decision for diagnostics (Compiled.resolutions).
    Distinct sites that share a shape signature get ordinal suffixes
    (``op[site]#2`` …) so the record counts every decision, not every
    distinct shape. When ``resolutions`` is a ``kernels.ResolutionLog``
    (the engine's lowering walk) the site-info dict is snapshotted too."""
    if resolutions is None:
        return
    key = f"{op}[{site}]"
    if key in resolutions:
        i = 2
        while f"{key}#{i}" in resolutions:
            i += 1
        key = f"{key}#{i}"
    resolutions[key] = impl.tier
    if info is not None and hasattr(resolutions, "record"):
        resolutions.record(key, op, site, impl.tier, dict(info))


def _shape_only(op: str, *args) -> torch.Tensor:
    """A dispatched op on ``meta`` tensors (the engine's lowering walk):
    an empty result of the right shape and dtype, nothing computed."""
    if op == "segment_sum":
        msg, _, num = args
        return msg.new_empty((num, msg.shape[1]))
    if op == "gather_join":
        table, rows = args
        return table.new_empty((rows.shape[0], table.shape[1]))
    x, y = args
    return x.new_empty((x.shape[0], y.shape[1]))


def _call(impl, op: str, *args) -> torch.Tensor:
    if args[0].is_meta:
        return _shape_only(op, *args)
    return impl.fn(*args)


# ---------------------------------------------------------------------------
# Join lowering: einsum path (dense ⋈ dense, multiplicative kernel)
# ---------------------------------------------------------------------------


def _dispatched_matmul_join(
    lspec: str,
    rspec: str,
    ospec: str,
    kernel: BinKernel,
    lrel: DenseRelation,
    rrel: DenseRelation,
    dispatch,
    resolutions: Optional[Dict],
) -> Optional[DenseRelation]:
    """Route a matmul-shaped Σ∘⋈ einsum through the ``blocked_matmul``
    dispatch op: contractions expressible as ONE 2-D matmul after
    flattening block axes — the MatMul chunk kernel ('mk','kn'→'mn') or a
    chunkless elementwise ⊗ — with every contracted block class shared by
    both sides and no batch class. Returns None to fall back to
    ``torch.einsum`` (including when the table resolves this site to the
    torch tier, which *is* the einsum path)."""
    if kernel.chunk_spec is not None:
        if kernel.chunk_spec != ("mk", "kn", "mn"):
            return None
        chunked = True
    elif kernel.elementwise and lrel.chunk_rank == 0 and rrel.chunk_rank == 0:
        chunked = False
    else:
        return None
    sl, sr, so = set(lspec), set(rspec), set(ospec)
    if len(sl) != len(lspec) or len(sr) != len(rspec) or len(so) != len(ospec):
        return None                  # repeated block class within one spec
    con = [c for c in lspec if c in sr and c not in so]
    if not con and not chunked:
        return None                  # outer product: nothing to win
    if (sl & sr) - set(con):
        return None                  # batch class (in both inputs + output)
    if (sl - set(con)) - so or (sr - set(con)) - so or so - (sl | sr):
        return None                  # unilateral sum / phantom output class

    l_keep = [c for c in lspec if c in so]
    r_keep = [c for c in rspec if c in so]
    la, ra = len(lspec), len(rspec)
    lext = {c: lrel.data.shape[lspec.index(c)] for c in lspec}
    rext = {c: rrel.data.shape[rspec.index(c)] for c in rspec}

    m, kk, n = (
        (lrel.data.shape[la], lrel.data.shape[la + 1], rrel.data.shape[ra + 1])
        if chunked
        else (1, 1, 1)
    )
    rows = math.prod(lext[c] for c in l_keep) * m
    inner = math.prod(lext[c] for c in con) * kk
    cols = math.prod(rext[c] for c in r_keep) * n

    ct = torch.result_type(lrel.data, rrel.data)
    info = {"m": rows, "k": inner, "n": cols, "dtype": ct}
    impl = kernels.resolve_impl("blocked_matmul", info, dispatch)
    _note(resolutions, "blocked_matmul", f"m={rows},k={inner},n={cols}", impl, info)
    if impl.tier == "torch":
        return None                  # the einsum below IS the torch tier

    lk_ax = [lspec.index(c) for c in l_keep]
    lc_ax = [lspec.index(c) for c in con]
    rk_ax = [rspec.index(c) for c in r_keep]
    rc_ax = [rspec.index(c) for c in con]
    if chunked:
        lperm = lk_ax + [la] + lc_ax + [la + 1]      # (keep.., m, con.., k)
        rperm = rc_ax + [ra] + rk_ax + [ra + 1]      # (con.., k, keep.., n)
    else:
        lperm = lk_ax + lc_ax
        rperm = rc_ax + rk_ax
    l2 = lrel.data.to(ct).permute(lperm).reshape(rows, inner).contiguous()
    r2 = rrel.data.to(ct).permute(rperm).reshape(inner, cols).contiguous()
    out2 = _call(impl, "blocked_matmul", l2, r2)

    shp = tuple(lext[c] for c in l_keep) + ((m,) if chunked else ())
    shp += tuple(rext[c] for c in r_keep) + ((n,) if chunked else ())
    out = out2.reshape(shp)
    # natural axis order: l_keep.., [m], r_keep.., [n] → ospec order + chunks
    ax_of = {c: i for i, c in enumerate(l_keep)}
    off = len(l_keep) + (1 if chunked else 0)
    for j, c in enumerate(r_keep):
        ax_of[c] = off + j
    perm = [ax_of[c] for c in ospec]
    if chunked:
        perm += [len(l_keep), off + len(r_keep)]
    return DenseRelation(out.permute(perm), key_arity=len(ospec))


def _einsum_join(
    join: fra.Join,
    grp: Optional[KeyFn],
    lrel: DenseRelation,
    rrel: DenseRelation,
    dispatch=None,
    resolutions: Optional[Dict] = None,
) -> DenseRelation:
    la, ra = join.left.key_arity, join.right.key_arity
    uf = join_equiv_classes(join.pred, la, ra)
    for a, b in join.pred.eqs:
        if isinstance(a, Lit) or isinstance(b, Lit):
            raise LoweringError("literal in einsum-join predicate")

    letters: Dict[object, str] = {}

    def letter(comp) -> str:
        root = uf.find(comp)
        if root not in letters:
            letters[root] = _BLOCK_LETTERS[len(letters)]
        return letters[root]

    lspec = "".join(letter(L(i)) for i in range(la))
    rspec = "".join(letter(R(j)) for j in range(ra))

    out_comps: List = list(join.proj.comps)
    if grp is not None:
        composed = []
        for c in grp.comps:
            if isinstance(c, Lit):
                raise LoweringError("Lit in grp over einsum join")
            composed.append(join.proj.comps[c.idx])
        out_comps = composed
    if any(isinstance(c, Lit) for c in out_comps):
        raise LoweringError("Lit in einsum join projection")
    ospec = "".join(letter(c) for c in out_comps)

    if grp is None:
        # A bare join must not implicitly aggregate: every block class must
        # survive into the output key.
        if not set(lspec + rspec) <= set(ospec):
            raise LoweringError(
                "bare join drops a key class (duplicate keys); wrap in Σ"
            )

    k = join.kernel
    if k.chunk_spec is not None:
        lc, rc, oc = k.chunk_spec
        if len(lc) != lrel.chunk_rank or len(rc) != rrel.chunk_rank:
            raise LoweringError(
                f"chunk rank mismatch for {k.name}: {lrel.chunk_rank},{rrel.chunk_rank}"
            )
    elif k.elementwise:
        cr = max(lrel.chunk_rank, rrel.chunk_rank)
        oc = string.ascii_lowercase[:cr]
        lc = oc[cr - lrel.chunk_rank:]
        rc = oc[cr - rrel.chunk_rank:]
    else:
        raise LoweringError(f"kernel {k.name} is not einsum-lowerable")

    routed = _dispatched_matmul_join(
        lspec, rspec, ospec, k, lrel, rrel, dispatch, resolutions
    )
    if routed is not None:
        return routed

    ct = torch.result_type(lrel.data, rrel.data)
    spec = f"{lspec}{lc},{rspec}{rc}->{ospec}{oc}"
    data = torch.einsum(spec, lrel.data.to(ct), rrel.data.to(ct))
    return DenseRelation(data, key_arity=len(out_comps))


# ---------------------------------------------------------------------------
# Join lowering: aligned/broadcast path (RJPs of σ and Σ, pointwise losses)
# ---------------------------------------------------------------------------


def _aligned_join(
    join: fra.Join, lrel: DenseRelation, rrel: DenseRelation
) -> Optional[DenseRelation]:
    """Joins whose projection is the identity on one side: the other side is
    permuted/broadcast into that side's grid and the kernel applied
    pointwise. Covers the RJP-of-Σ broadcast join, the RJP-of-σ join, and
    pointwise losses (⊗ against labels with proj → keyL)."""
    la, ra = join.left.key_arity, join.right.key_arity
    lr, llit, rlit = _norm_pairs(join.pred)

    id_over_R = join.proj.comps == tuple(R(j) for j in range(ra))
    id_over_L = join.proj.comps == tuple(L(i) for i in range(la))
    if id_over_R:
        base_rel, base_arity = rrel, ra
        mapped_rel, mapped_arity = lrel, la
        pairs = [(i, j) for i, j in lr]          # mapped comp i ↔ base comp j
        mapped_lit, base_lit = llit, rlit
        order = "lr"
    elif id_over_L:
        base_rel, base_arity = lrel, la
        mapped_rel, mapped_arity = rrel, ra
        pairs = [(j, i) for i, j in lr]
        mapped_lit, base_lit = rlit, llit
        order = "rl"
    else:
        return None

    m2b = dict(pairs)
    if len(m2b) != len(pairs) or len(set(m2b.values())) != len(m2b):
        return None
    if len(m2b) != mapped_arity or mapped_lit:
        return None  # a mapped axis is unconstrained -> would need summation

    # Permute mapped block axes into base-axis order, insert broadcast axes.
    src = mapped_rel.data
    perm = sorted(range(mapped_arity), key=lambda i: m2b[i])
    src = src.permute(tuple(perm) + tuple(range(mapped_arity, src.dim())))
    matched_base = set(m2b.values())
    for j in range(base_arity):
        if j not in matched_base:
            src = src.unsqueeze(j)
    # src now has base_arity block axes (some size-1) + mapped chunk dims;
    # broadcast explicitly so pointwise kernels that ignore one operand
    # (e.g. the Σ-RJP's take_l) still produce full-grid outputs.
    src = src.expand(base_rel.extents + tuple(src.shape[base_arity:]))

    bb = base_rel.data
    kfn = _vmapped(join.kernel.fn, base_arity)
    if order == "lr":
        val = kfn(src, bb)
    else:
        val = kfn(bb, src)

    out_arity = base_arity
    if base_lit:
        dev = base_rel.data.device
        idx = torch.ones(base_rel.extents, dtype=torch.bool, device=dev)
        for j, v in base_lit:
            ax_shape = [1] * base_arity
            ax_shape[j] = base_rel.extents[j]
            m = (torch.arange(base_rel.extents[j], device=dev) == v).reshape(ax_shape)
            idx = idx & m
        mask = idx.reshape(idx.shape + (1,) * (val.dim() - out_arity))
        val = torch.where(mask, val, _zero(val))
    return DenseRelation(val, key_arity=out_arity)


def _broadcast_join(
    join: fra.Join,
    grp: Optional[KeyFn],
    lrel: DenseRelation,
    rrel: DenseRelation,
) -> Optional[DenseRelation]:
    """Last-resort dense ⋈ dense lowering for kernels with no einsum hints
    and non-aligned projections (e.g. the autodiff general path's inner
    join under a merging Σ): materialize the joint key-class grid,
    broadcast both operands into it, apply the kernel pointwise, and sum
    out the classes the (grp-composed) output key drops. Cost is the full
    class-grid product — the paper's *unoptimized* RJP — so the einsum and
    aligned paths are always tried first."""
    la, ra = join.left.key_arity, join.right.key_arity
    for a, b in join.pred.eqs:
        if isinstance(a, Lit) or isinstance(b, Lit):
            return None
    uf = join_equiv_classes(join.pred, la, ra)

    out_comps: List = list(join.proj.comps)
    if grp is not None:
        composed = []
        for c in grp.comps:
            if isinstance(c, Lit):
                return None
            composed.append(join.proj.comps[c.idx])
        out_comps = composed
    if any(isinstance(c, Lit) for c in out_comps):
        return None

    # one grid axis per join equivalence class, first-appearance order
    ax_of: Dict[object, int] = {}
    extents: List[int] = []
    lcomps = tuple(L(i) for i in range(la))
    rcomps = tuple(R(j) for j in range(ra))
    for comps, rel in ((lcomps, lrel), (rcomps, rrel)):
        for k, c in enumerate(comps):
            root = uf.find(c)
            if root not in ax_of:
                ax_of[root] = len(extents)
                extents.append(rel.extents[k])
    out_ax: List[int] = []
    for c in out_comps:
        ax = ax_of[uf.find(c)]
        if ax in out_ax:
            return None          # repeated class in output key (diagonal)
        out_ax.append(ax)
    if grp is None and len(out_ax) != len(extents):
        # a bare join dropping a class would emit duplicate keys
        return None

    def into_grid(rel: DenseRelation, comps) -> Optional[torch.Tensor]:
        axes = [ax_of[uf.find(c)] for c in comps]
        if len(set(axes)) != len(axes):
            return None          # intra-side equality (diagonal operand)
        perm = sorted(range(len(axes)), key=lambda i: axes[i])
        data = rel.data.permute(tuple(perm) + tuple(range(len(axes), rel.data.dim())))
        present = set(axes)
        for ax in range(len(extents)):
            if ax not in present:
                data = data.unsqueeze(ax)
        return data.expand(tuple(extents) + rel.chunk_shape)

    lb = into_grid(lrel, lcomps)
    rb = into_grid(rrel, rcomps)
    if lb is None or rb is None:
        return None
    val = _vmapped(join.kernel.fn, len(extents))(lb, rb)
    drop = tuple(ax for ax in range(len(extents)) if ax not in out_ax)
    if drop:
        val = val.sum(dim=drop)
    remaining = [ax for ax in range(len(extents)) if ax not in drop]
    perm = [remaining.index(ax) for ax in out_ax]
    val = val.permute(tuple(perm) + tuple(range(len(out_ax), val.dim())))
    return DenseRelation(val, key_arity=len(out_comps))


# ---------------------------------------------------------------------------
# Join lowering: gather path (one side COO)
# ---------------------------------------------------------------------------


def _dispatched_gather(
    dense: DenseRelation,
    idx_cols: Tuple[torch.Tensor, ...],
    dispatch,
    resolutions: Optional[Dict],
) -> torch.Tensor:
    """Gather rows of ``dense`` at per-key-dim index columns through the
    ``gather_join`` dispatch op: the key grid is flattened to one row axis
    and the chunk to one feature axis, matching the op contract
    ``fn(table2d, rows) → table2d[rows]`` (out-of-range / negative ids —
    the COO nnz padding — yield zero rows). Returns (E, *chunk)."""
    assert len(idx_cols) == dense.key_arity and dense.key_arity > 0
    e = idx_cols[0].shape[0]
    chunk = dense.chunk_shape
    dev = dense.data.device
    if e == 0:
        # zero-nnz COO guard: every tier agrees on the empty gather
        return dense.data.new_zeros((0,) + chunk)
    # flat row ids; any out-of-range component poisons the row to -1 so
    # the kernel's mask drops it
    valid = None
    flat = torch.zeros((e,), dtype=torch.int32, device=dev)
    for ext, col in zip(dense.extents, idx_cols):
        col = col.to(torch.int32)
        ok = (col >= 0) & (col < ext)
        valid = ok if valid is None else (valid & ok)
        flat = flat * ext + col.clamp(0, max(ext - 1, 0))
    rows = torch.where(valid, flat, torch.full((), -1, dtype=torch.int32, device=dev))
    n = math.prod(dense.extents)
    d = math.prod(chunk)
    info = {"rows": e, "num_rows": n, "dim": d, "dtype": dense.data.dtype}
    impl = kernels.resolve_impl("gather_join", info, dispatch)
    _note(resolutions, "gather_join", f"E={e},N={n},D={d}", impl, info)
    table2 = dense.data.reshape(n, d).contiguous()
    return _call(impl, "gather_join", table2, rows.contiguous()).reshape((e,) + chunk)


def _mask_padded_rows(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Zero value rows whose key carries a negative (padding) component, so
    padded nnz rows stay inert through non-multiplicative kernels too."""
    valid = (keys >= 0).all(dim=1)
    return torch.where(valid.reshape((-1,) + (1,) * (vals.dim() - 1)), vals, _zero(vals))


def _coo_join(
    join: fra.Join, lrel: AnyRel, rrel: AnyRel, dispatch, resolutions,
    offsets: Optional[Tuple[int, ...]] = None,
    dense_extents: Optional[Tuple[int, ...]] = None,
) -> CooRelation:
    """COO ⋈ dense: gather the dense rows at the COO keys. On a mesh the
    dense side may be one rank's slab: ``offsets`` are its first key per
    dim (a key outside the slab gathers a zero row) and ``dense_extents``
    its whole extents (the output's key domain)."""
    coo_is_left = isinstance(lrel, CooRelation)
    coo = lrel if coo_is_left else rrel
    dense = rrel if coo_is_left else lrel
    assert isinstance(dense, DenseRelation)
    lr, llit, rlit = _norm_pairs(join.pred)
    if llit or rlit:
        raise LoweringError("literal predicates on COO joins not supported")
    # (coo column ↔ dense comp) pairs
    if coo_is_left:
        pairs = [(i, j) for i, j in lr]
    else:
        pairs = [(j, i) for i, j in lr]
    d2c = {j: i for i, j in pairs}
    if len(d2c) != dense.key_arity:
        raise LoweringError(
            "COO join requires every dense key component matched (gather)"
        )
    idx = tuple(
        coo.keys[:, d2c[j]] - offsets[j] if offsets and offsets[j] else coo.keys[:, d2c[j]]
        for j in range(dense.key_arity)
    )
    gathered = _dispatched_gather(dense, idx, dispatch, resolutions)
    dext = dense.extents if dense_extents is None else dense_extents
    kfn = _vmapped(join.kernel.fn, 1)
    if coo_is_left:
        vals = kfn(coo.values, gathered)
    else:
        vals = kfn(gathered, coo.values)
    vals = _mask_padded_rows(coo.keys, vals)

    cols = []
    extents = []
    for c in join.proj.comps:
        if isinstance(c, Lit):
            cols.append(coo.keys.new_full((coo.nnz,), c.val))
            extents.append(c.val + 1)
            continue
        if coo_is_left:
            col = c.idx if isinstance(c, L) else d2c[c.idx]
            ext = coo.extents[c.idx] if isinstance(c, L) else dext[c.idx]
        else:
            col = c.idx if isinstance(c, R) else d2c[c.idx]
            ext = coo.extents[c.idx] if isinstance(c, R) else dext[c.idx]
        cols.append(coo.keys[:, col])
        extents.append(ext)
    keys = torch.stack(cols, dim=1) if cols else coo.keys.new_zeros((coo.nnz, 0))
    return CooRelation(keys, vals, tuple(extents))


# ---------------------------------------------------------------------------
# Restrict lowering: fused per-tuple gather for sparse gradients
# ---------------------------------------------------------------------------


def _solve_side_from_output(
    pred: JoinPred, proj: JoinProj, la: int, ra: int
):
    """For Restrict(Join(...), coo): reconstruct each input key component of
    the join from the *output* key columns (+ pred equalities). Returns
    (left_exprs, right_exprs) where each expr is an output column index or
    a Lit, or None if some component is underdetermined."""
    uf = join_equiv_classes(pred, la, ra)
    col_of: Dict[object, object] = {}
    for p, c in enumerate(proj.comps):
        if isinstance(c, Lit):
            continue
        col_of.setdefault(uf.find(c), p)
    for a, b in pred.eqs:
        for c in (a, b):
            if isinstance(c, Lit):
                col_of.setdefault(uf.find(c), Lit(c.val))

    def solve(comps):
        out = []
        for c in comps:
            e = col_of.get(uf.find(c))
            if e is None:
                return None
            out.append(e)
        return out

    lex = solve([L(i) for i in range(la)])
    rex = solve([R(j) for j in range(ra)])
    if lex is None or rex is None:
        return None
    return lex, rex


def _restricted_join(
    join: fra.Join,
    ref: CooRelation,
    lrel: AnyRel,
    rrel: AnyRel,
    dispatch=None,
    resolutions: Optional[Dict] = None,
) -> CooRelation:
    """Evaluate a dense⋈dense join only at the key set of ``ref``: gather
    both operands per ref-tuple and apply the kernel pointwise. This is the
    sparse-gradient fast path (e.g. ∂loss/∂edge_weights = g[dst]·h[src]);
    the per-tuple gathers route through the ``gather_join`` dispatch op."""
    if not (isinstance(lrel, DenseRelation) and isinstance(rrel, DenseRelation)):
        raise LoweringError("restricted join requires dense operands")
    la, ra = join.left.key_arity, join.right.key_arity
    solved = _solve_side_from_output(join.pred, join.proj, la, ra)
    if solved is None:
        raise LoweringError("restricted join underdetermined (needs Σ)")
    lex, rex = solved

    def gather(rel: DenseRelation, exprs):
        idx = []
        for e in exprs:
            if isinstance(e, Lit):
                idx.append(ref.keys.new_full((ref.nnz,), e.val))
            else:
                idx.append(ref.keys[:, e])
        return (
            _dispatched_gather(rel, tuple(idx), dispatch, resolutions)
            if idx
            else rel.data.expand((ref.nnz,) + rel.chunk_shape)
        )

    lv = gather(lrel, lex)
    rv = gather(rrel, rex)
    vals = _vmapped(join.kernel.fn, 1)(lv, rv)
    vals = _mask_padded_rows(ref.keys, vals)
    # Chunk-level broadcasting in the forward kernel (e.g. scalar edge
    # weight × embedding chunk) dualizes to a reduction in the backward:
    # sum the VJP chunk down to the target relation's chunk shape.
    tgt = ref.chunk_shape
    extra = (vals.dim() - 1) - len(tgt)
    if extra > 0:
        vals = vals.sum(dim=tuple(range(1, 1 + extra)))
    for ax, (got, want) in enumerate(zip(vals.shape[1:], tgt)):
        if got != want:
            assert want == 1, (vals.shape, tgt)
            vals = vals.sum(dim=1 + ax, keepdim=True)
    return CooRelation(
        ref.keys, vals, ref.extents, ref.owner_dim, ref.shard_offsets
    )


def _select_coo(n: fra.Select, rel: CooRelation) -> CooRelation:
    if not n.pred.always_true:
        raise LoweringError("predicated σ over COO not supported")
    cols = []
    extents = []
    for c in n.proj.comps:
        if isinstance(c, Lit):
            raise LoweringError("Lit proj over COO")
        cols.append(rel.keys[:, c.idx])
        extents.append(rel.extents[c.idx])
    keys = torch.stack(cols, dim=1)
    vals = _vmapped(n.kernel.fn, 1)(rel.values)
    # σ kernels with f(0) != 0 would resurrect padded rows;
    # re-mask so they stay inert through full-reduce Σs
    vals = _mask_padded_rows(rel.keys, vals)
    return CooRelation(keys, vals, tuple(extents))


def _select_proj(n: fra.Select) -> Tuple[Dict[int, object], List[int], List[int]]:
    """(fixed components, surviving components, σ's permutation of the
    survivors) of a σ over a dense relation."""
    if n.pred.custom is not None:
        raise LoweringError("custom σ predicate not compilable")
    fixed = dict(n.pred.eqs)
    remaining = [i for i in range(n.child.key_arity) if i not in fixed]
    proj_idx = []
    for c in n.proj.comps:
        if isinstance(c, Lit):
            raise LoweringError("Lit σ projection over dense")
        if c.idx in fixed:
            raise LoweringError("σ projects a predicate-fixed component")
        proj_idx.append(remaining.index(c.idx))
    if sorted(proj_idx) != list(range(len(remaining))):
        raise LoweringError("σ projection must permute surviving comps")
    return fixed, remaining, proj_idx


def _select_dense(n: fra.Select, rel: DenseRelation) -> DenseRelation:
    fixed, remaining, proj_idx = _select_proj(n)
    data = rel.data
    # select fixed components (descending so axes stay valid)
    for i in sorted(fixed, reverse=True):
        data = data.select(i, fixed[i])
    chunk_axes = tuple(range(len(remaining), data.dim()))
    data = data.permute(tuple(proj_idx) + chunk_axes)
    data = _vmapped(n.kernel.fn, len(proj_idx))(data)
    return DenseRelation(data, key_arity=len(proj_idx))


def _agg_keep(grp: KeyFn, arity: int) -> List[int]:
    """The child key components a Σ over a dense relation keeps, in grp
    order (none for a full reduction)."""
    if all(isinstance(c, Lit) for c in grp.comps) and grp.arity_out == 0:
        return []
    if any(isinstance(c, Lit) for c in grp.comps):
        raise LoweringError("mixed Lit grp over dense not supported")
    keep = [c.idx for c in grp.comps]
    if len(set(keep)) != len(keep):
        raise LoweringError("duplicate grp components over dense")
    return keep


def _agg_dense(grp: KeyFn, rel: DenseRelation) -> DenseRelation:
    arity = rel.key_arity
    keep = _agg_keep(grp, arity)
    if not keep:
        data = rel.data.sum(dim=tuple(range(arity))) if arity else rel.data
        return DenseRelation(data, key_arity=0)
    drop = tuple(i for i in range(arity) if i not in keep)
    data = rel.data.sum(dim=drop) if drop else rel.data
    # axes now ordered by ascending original idx; permute to grp order
    remaining = [i for i in range(arity) if i not in drop]
    perm = [remaining.index(i) for i in keep]
    data = data.permute(tuple(perm) + tuple(range(len(keep), data.dim())))
    return DenseRelation(data, key_arity=len(keep))


def _agg_coo(grp: KeyFn, rel: CooRelation, dispatch, resolutions) -> DenseRelation:
    """Σ over a COO relation: the segment sum of its values by the kept
    key columns into the dense grid of their extents."""
    if any(isinstance(c, Lit) for c in grp.comps):
        raise LoweringError("Lit grp over COO not supported")
    keep = [c.idx for c in grp.comps]
    extents = tuple(rel.extents[i] for i in keep)
    if rel.nnz == 0:
        # zero-nnz guard: the Σ of no tuples is the ⊕-unit grid,
        # emitted without dispatching
        return DenseRelation(
            rel.values.new_zeros(extents + rel.chunk_shape),
            key_arity=len(extents),
        )
    if not extents:
        return DenseRelation(rel.values.sum(dim=0), key_arity=0)
    flat = torch.zeros((rel.nnz,), dtype=torch.int32, device=rel.keys.device)
    stride = 1
    for i in reversed(range(len(keep))):
        flat = flat + rel.keys[:, keep[i]].to(torch.int32) * stride
        stride *= extents[i]
    num = math.prod(extents)
    chunk = rel.chunk_shape
    d = math.prod(chunk)
    info = {
        "nnz": rel.nnz, "dim": d, "num_segments": num,
        "dtype": rel.values.dtype,
    }
    impl = kernels.resolve_impl("segment_sum", info, dispatch)
    _note(resolutions, "segment_sum", f"E={rel.nnz},D={d},S={num}", impl, info)
    msg = rel.values.reshape((rel.nnz, d)).contiguous()
    summed = _call(impl, "segment_sum", msg, flat, num)          # (num, d)
    return DenseRelation(
        summed.reshape(extents + chunk), key_arity=len(extents)
    )


def _dense_join(
    n: fra.Join, grp: Optional[KeyFn], lrel: DenseRelation, rrel: DenseRelation,
    dispatch, resolutions,
) -> DenseRelation:
    """Dense ⋈ dense (under an optional Σ ``grp``): the einsum path, the
    aligned path, then the class-grid broadcast."""
    k = n.kernel
    if k.elementwise or k.chunk_spec is not None:
        try:
            return _einsum_join(
                n, grp, lrel, rrel, dispatch=dispatch, resolutions=resolutions
            )
        except LoweringError:
            pass
    al = _aligned_join(n, lrel, rrel)
    if al is not None:
        if grp is not None:
            al = _agg_dense(grp, al)
        return al
    bc = _broadcast_join(n, grp, lrel, rrel)
    if bc is not None:
        return bc
    raise LoweringError(f"cannot lower join {n.describe()}")


def _add(a: AnyRel, b: AnyRel) -> DenseRelation:
    if isinstance(a, DenseRelation) and isinstance(b, DenseRelation):
        return DenseRelation(a.data + b.data, a.key_arity)
    if isinstance(a, DenseRelation) and isinstance(b, CooRelation):
        a, b = b, a
    if isinstance(a, CooRelation) and isinstance(b, DenseRelation):
        # accumulate into a copy: b may be a catalog tensor
        idx = tuple(a.keys[:, i].long() for i in range(a.key_arity))
        out = b.data.clone()
        out.index_put_(idx, a.values.to(out.dtype), accumulate=True)
        return DenseRelation(out, b.key_arity)
    raise LoweringError("COO + COO add not supported")


def _gather_at(ref: CooRelation, child: DenseRelation, dispatch, resolutions) -> CooRelation:
    """A dense relation restricted to a COO key set: its rows gathered at
    the ref's keys (padding rows gather zeros)."""
    idx = tuple(ref.keys[:, i] for i in range(ref.key_arity))
    vals = _dispatched_gather(child, idx, dispatch, resolutions)
    return CooRelation(ref.keys, vals, ref.extents, ref.owner_dim, ref.shard_offsets)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


def _execute_graph(
    root: fra.Node,
    env: Env,
    cache: Optional[Env] = None,
    *,
    fuse_join_agg: bool = True,
    dispatch: kernels.DispatchTable,
    resolutions: Optional[Dict] = None,
    place: Optional["Placement"] = None,
) -> AnyRel:
    """Walk a query graph over chunked relations, lowering each node to
    tensor ops. This is the engine's *lowering primitive*: it runs once on
    ``meta`` tensors when the engine lowers a program, and once per call
    on real tensors. With ``place`` (a ``Placement``) the walk runs on one
    rank's shards of a mesh step (``_execute_placed``).

    ``fuse_join_agg=False`` materializes every Join's output individually
    instead of fusing Σ∘⋈ into one einsum — needed when a gradient program
    built *without* the §4 join-agg-fusion optimization will consume the
    join intermediates.

    ``dispatch`` is a kernels.DispatchTable steering the segment-sum /
    blocked-matmul / gather hot-spots to a physical tier; ``resolutions``
    (optional dict) collects ``op[site] → tier`` records of every dispatch
    decision made during the walk."""
    if place is not None:
        return _execute_placed(
            root, env, cache, place, fuse_join_agg=fuse_join_agg,
            dispatch=dispatch, resolutions=resolutions,
        )
    memo: Dict[int, AnyRel] = {}

    def ex(n: fra.Node) -> AnyRel:
        if n.id in memo:
            return memo[n.id]
        out = _ex(n)
        memo[n.id] = out
        if cache is not None:
            cache[f"__fwd_{n.id}"] = out
        return out

    def _join(n: fra.Join, grp: Optional[KeyFn]) -> AnyRel:
        lrel, rrel = ex(n.left), ex(n.right)
        if isinstance(lrel, CooRelation) or isinstance(rrel, CooRelation):
            if isinstance(lrel, CooRelation) and isinstance(rrel, CooRelation):
                raise LoweringError("COO ⋈ COO not supported")
            out = _coo_join(n, lrel, rrel, dispatch, resolutions)
            if grp is not None:
                out = _agg_coo(grp, out, dispatch, resolutions)
            return out
        return _dense_join(n, grp, lrel, rrel, dispatch, resolutions)

    def _ex(n: fra.Node) -> AnyRel:
        if isinstance(n, fra.TableScan):
            return env[n.name]
        if isinstance(n, fra.Const):
            return env[n.ref]
        if isinstance(n, fra.Select):
            rel = ex(n.child)
            if isinstance(rel, CooRelation):
                return _select_coo(n, rel)
            return _select_dense(n, rel)
        if isinstance(n, fra.Agg):
            if isinstance(n.child, fra.Join) and fuse_join_agg:
                if not n.kernel.is_add:
                    raise LoweringError("non-additive Σ over ⋈ not supported")
                return _join(n.child, n.grp)
            rel = ex(n.child)
            if not n.kernel.is_add:
                raise LoweringError("non-additive Σ not supported in compiler")
            if isinstance(rel, CooRelation):
                return _agg_coo(n.grp, rel, dispatch, resolutions)
            return _agg_dense(n.grp, rel)
        if isinstance(n, fra.Join):
            return _join(n, None)
        if isinstance(n, fra.Restrict):
            ref = ex(n.ref)
            if isinstance(ref, DenseRelation):
                # Full-grid key set: the restriction is the identity.
                return ex(n.child)
            assert isinstance(ref, CooRelation)
            if isinstance(n.child, fra.Join):
                lrel, rrel = ex(n.child.left), ex(n.child.right)
                if isinstance(lrel, DenseRelation) and isinstance(rrel, DenseRelation):
                    return _restricted_join(
                        n.child, ref, lrel, rrel, dispatch, resolutions
                    )
            child = ex(n.child)
            if isinstance(child, CooRelation):
                # By construction RJP outputs over a sparse target reuse the
                # target's key order.
                return child
            # Dense child: gather at ref keys (padding rows gather zeros).
            return _gather_at(ref, child, dispatch, resolutions)
        if isinstance(n, fra.AddOp):
            return _add(ex(n.left), ex(n.right))
        raise TypeError(f"unknown node {n}")

    try:
        return ex(root)
    finally:
        # ex and _ex call each other through their closure cells: a
        # reference cycle that holds env, memo and every intermediate
        # (full-size tensors on the card) until Python's cycle collector
        # runs. Unbinding ex breaks it, so they are freed when the walk ends
        ex = None  # noqa: F841


def _table_for(dispatch, env: Env, seed: Optional[AnyRel] = None) -> kernels.DispatchTable:
    """``dispatch`` as a DispatchTable for the device type of ``env``."""
    from .engine import env_device

    return kernels.make_table(dispatch, backend=env_device(env, seed).type)


def execute(
    root: fra.Node,
    env: Env,
    cache: Optional[Env] = None,
    *,
    fuse_join_agg: bool = True,
    dispatch=None,
) -> AnyRel:
    """Eager execution: the engine's eager mode on an anonymous graph. It
    walks the graph at every call and registers no engine (callers often
    build throwaway graphs; interning them would only pin memory). Use the
    ``repro_torch.Database`` session (``db.query(...)`` /
    ``db.execute(...)``) for the staged path.

    ``dispatch`` accepts anything ``kernels.make_table`` does (a tier
    name, a {op: tier} dict, a DispatchTable); None keeps the default of
    the device type the environment lies on (the CUDA kernels on the
    card, the plain torch lowerings on the CPU)."""
    table = _table_for(dispatch, env)
    return _execute_graph(
        root, env, cache, fuse_join_agg=fuse_join_agg, dispatch=table
    )


def run_query(q: fra.Query, env: Env, *, dispatch=None) -> AnyRel:
    """Eager execution of a whole Query (see ``execute``)."""
    return _execute_graph(q.root, env, dispatch=_table_for(dispatch, env))


def execute_with_cache(
    root: fra.Node, env: Env, *, fuse_join_agg: bool = True, dispatch=None
) -> Tuple[AnyRel, Env]:
    """Forward pass caching every evaluated node's chunked relation under
    ``__fwd_<id>``, for the gradient graphs (Algorithm 2 line 6). Joins
    consumed by a fusing Agg are evaluated inside the fused product and are
    not cached on their own; pass ``fuse_join_agg=False`` when the
    gradient program was built without join-agg fusion and needs the join
    intermediates."""
    fwd: Env = {}
    out = _execute_graph(
        root, env, cache=fwd, fuse_join_agg=fuse_join_agg,
        dispatch=_table_for(dispatch, env),
    )
    return out, fwd


def grad_eval(
    prog,
    env: Env,
    seed: Optional[AnyRel] = None,
    *,
    fuse_join_agg: bool = True,
    dispatch=None,
) -> Tuple[AnyRel, Dict[str, AnyRel]]:
    """Execute a GradientProgram (autodiff.py) eagerly: the forward with
    its cache, then each gradient query graph, under one table for all of
    them. A thin wrapper over the engine's eager mode; the staged
    equivalent is a ``repro_torch.Database`` handle's ``step()``."""
    from .engine import engine_for

    return engine_for(prog, fuse_join_agg=fuse_join_agg).eager(
        env, seed, dispatch=dispatch
    )


# ---------------------------------------------------------------------------
# The executor on a mesh: one rank's shards, explicit collectives
# ---------------------------------------------------------------------------


def spec_layout(spec, geometry, arity: int) -> Layout:
    """The ``Layout`` of a partition spec on a mesh of ``geometry``: key
    dim (a COO's dim 0, its nnz rows) → "model" or "data"."""
    out: Layout = {}
    for d, entry in enumerate(tuple(spec or ())):
        if entry is None or d >= arity:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        out[d] = "model" if geometry.model_axis in axes else "data"
    return out


def spec_folds(spec, geometry, arity: int) -> set:
    """The key dims a partition spec cuts over the model axis and the data
    axes at once (a ``DTensor`` placed ``[Shard(0), Shard(0)]`` on a
    ("data", "model") mesh): ``spec_layout`` names them "model", and the
    rank holds a slab of the ("data", "model") fold, data outermost."""
    out = set()
    for d, entry in enumerate(tuple(spec or ())):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if (entry is not None and d < arity and geometry.model_axis in axes
                and any(a in geometry.data_axes for a in axes)):
            out.add(d)
    return out


class Placement:
    """One rank's view of a step on a mesh: the collective layer ``comm``
    (``launch.collectives.MeshComm``: the axis groups' sizes, this rank's
    index in each, the collectives), the ``Layout`` of every relation of
    the environment by name (the walk adds the forward intermediates it
    caches, ``__fwd_<id>``), and the ``JoinPlan`` per join id."""

    def __init__(self, comm, layouts: Dict[str, Layout], plans: Optional[Dict] = None):
        self.comm = comm
        self.layouts: Dict[str, Layout] = {k: dict(v) for k, v in layouts.items()}
        self.plans = dict(plans or {})

    # -- one dim ------------------------------------------------------------

    def slice(self, rel: AnyRel, dim: int, kind: str) -> AnyRel:
        """This rank's slab of a whole ``dim`` (0 = the nnz rows of a COO
        relation) over the ``kind`` group: a view, no communication."""
        size = self.comm.size[kind]
        if size == 1:
            return rel
        if isinstance(rel, CooRelation):
            per, rem = divmod(rel.nnz, size)
            if rem:
                raise LoweringError(f"{rel.nnz} nnz rows do not split over {size} ranks")
            at = self.comm.index[kind] * per
            return CooRelation(
                rel.keys.narrow(0, at, per), rel.values.narrow(0, at, per),
                rel.extents, rel.owner_dim, rel.shard_offsets,
            )
        per, rem = divmod(int(rel.data.shape[dim]), size)
        if rem:
            raise LoweringError(f"extent {rel.data.shape[dim]} does not split over {size} ranks")
        return DenseRelation(
            rel.data.narrow(dim, self.comm.index[kind] * per, per), rel.key_arity
        )

    def gather(self, rel: AnyRel, dim: int, kind: str) -> AnyRel:
        """The whole ``dim`` from every rank's slab (an all-gather)."""
        if isinstance(rel, CooRelation):
            return CooRelation(
                self.comm.all_gather(rel.keys, 0, kind),
                self.comm.all_gather(rel.values, 0, kind),
                rel.extents, rel.owner_dim, rel.shard_offsets,
            )
        return DenseRelation(self.comm.all_gather(rel.data, dim, kind), rel.key_arity)

    def offset(self, rel: DenseRelation, dim: int, kind: str) -> int:
        """The first key of this rank's slab of ``dim``."""
        return self.comm.index[kind] * int(rel.data.shape[dim])

    # -- layouts ------------------------------------------------------------

    def move(self, rel: AnyRel, lay: Layout, target: Layout) -> Tuple[AnyRel, Layout]:
        """``rel`` (laid out as ``lay``) laid out as ``target``: sharded
        dims the target wants whole are gathered, whole dims it wants
        sharded are sliced."""
        for d, k in sorted(lay.items()):
            if target.get(d) != k:
                rel = self.gather(rel, d, k)
        now = {d: k for d, k in lay.items() if target.get(d) == k}
        for d, k in sorted(target.items()):
            if d not in now:
                rel = self.slice(rel, d, k)
                now[d] = k
        return rel, now

    def unfold(self, rel: AnyRel, lay: Layout, dims) -> Tuple[AnyRel, Layout]:
        """``rel`` with ``dims`` (cut over the ("data", "model") fold,
        ``spec_folds``) whole on every rank: the model group's slabs are
        gathered first (they are consecutive), then the data group's."""
        for d in sorted(dims):
            rel = self.gather(self.gather(rel, d, "model"), d, "data")
        return rel, {d: k for d, k in lay.items() if d not in dims}

    def whole(self, rel: AnyRel, lay: Layout, dims=None) -> Tuple[AnyRel, Layout]:
        """``rel`` with ``dims`` (every dim when None) whole on every rank."""
        keep = {} if dims is None else {d: k for d, k in lay.items() if d not in dims}
        return self.move(rel, lay, keep)

    def reduce(self, rel: AnyRel, lay: Layout, partial, scatter: bool = False) -> Tuple[AnyRel, Layout]:
        """Sum the partial sums ``rel`` holds over each group of
        ``partial``. With ``scatter`` (the Σ-scatter of a nnz-sharded plan)
        a data-group sum is a reduce-scatter of the grid's rows where they
        split evenly: each rank keeps its row slab."""
        lay = dict(lay)
        for kind in sorted(partial):
            if self.comm.size[kind] == 1:
                continue
            if isinstance(rel, CooRelation):
                rel = CooRelation(
                    rel.keys, self.comm.all_reduce(rel.values, kind), rel.extents,
                    rel.owner_dim, rel.shard_offsets,
                )
            elif (
                scatter and kind == "data" and rel.key_arity > 0 and 0 not in lay
                and kind not in lay.values()
                and rel.data.shape[0] % self.comm.size[kind] == 0
            ):
                rel = DenseRelation(self.comm.reduce_scatter(rel.data, 0, kind), rel.key_arity)
                lay[0] = kind
            else:
                rel = DenseRelation(self.comm.all_reduce(rel.data, kind), rel.key_arity)
        return rel, lay

    def plan_layout(self, plan, side: str, rel: AnyRel, lay: Layout, arity: int) -> Layout:
        """The layout a join's ``plan`` wants one operand (now laid out as
        ``lay``) in: a dim whose whole extent does not split over its
        group stays whole."""
        out: Layout = {}
        for d, kind in spec_layout(plan.pspec(side, arity), self.comm.geometry, arity).items():
            ext = rel.nnz if isinstance(rel, CooRelation) else int(rel.data.shape[d])
            if d in lay:
                ext *= self.comm.size[lay[d]]
            if ext % self.comm.size[kind] == 0:
                out[d] = kind
        return out


def _execute_placed(
    root: fra.Node,
    env: Env,
    cache: Optional[Env],
    place: Placement,
    *,
    fuse_join_agg: bool,
    dispatch: kernels.DispatchTable,
    resolutions: Optional[Dict],
) -> AnyRel:
    """``_execute_graph`` on one rank's shards (module docstring). The
    relations of ``env`` are this rank's shards, laid out as
    ``place.layouts`` says; the result is whole."""
    memo: Dict[int, Tuple[AnyRel, Layout]] = {}

    def ex(n: fra.Node) -> Tuple[AnyRel, Layout]:
        if n.id in memo:
            return memo[n.id]
        out = _ex(n)
        memo[n.id] = out
        if cache is not None:
            cache[f"__fwd_{n.id}"] = out[0]
            place.layouts[f"__fwd_{n.id}"] = dict(out[1])
        return out

    def comp_of(side: str, d: int):
        return L(d) if side == "left" else R(d)

    def coo_join(n, grp, lrel, ll, rrel, rl, plan):
        coo_left = isinstance(lrel, CooRelation)
        coo, cl = (lrel, ll) if coo_left else (rrel, rl)
        dense, dl = (rrel, rl) if coo_left else (lrel, ll)
        nnz_kind = cl.get(0)
        # the gather reads a dense slab in place when the nnz rows are not
        # split over the same group and a zero row gathers to zero
        dense, dl = place.move(dense, dl, {
            d: k for d, k in dl.items() if k != nnz_kind and n.kernel.multiplicative
        })
        offsets = tuple(
            place.offset(dense, j, dl[j]) if j in dl else 0 for j in range(dense.key_arity)
        )
        extents = tuple(
            int(dense.data.shape[j]) * (place.comm.size[dl[j]] if j in dl else 1)
            for j in range(dense.key_arity)
        )
        lrel, rrel = (coo, dense) if coo_left else (dense, coo)
        out = _coo_join(n, lrel, rrel, dispatch, resolutions, offsets=offsets,
                        dense_extents=extents)
        partial = set(dl.values())
        if grp is None:
            return place.reduce(out, {0: nnz_kind} if nnz_kind else {}, partial)
        out = _agg_coo(grp, out, dispatch, resolutions)
        if nnz_kind:
            partial.add(nnz_kind)
        scatter = plan is not None and plan.data_kind.startswith("data:shard_nnz")
        return place.reduce(out, {}, partial, scatter=scatter)

    def dense_join(n, grp, lrel, ll, rrel, rl):
        la, ra = n.left.key_arity, n.right.key_arity
        try:
            _, llit, rlit = _norm_pairs(n.pred)
        except LoweringError:
            llit, rlit = [(i, None) for i in range(la)], [(j, None) for j in range(ra)]
        # a literal names a whole-domain key: its dim must be whole
        lrel, ll = place.whole(lrel, ll, {i for i, _ in llit})
        rrel, rl = place.whole(rrel, rl, {j for j, _ in rlit})
        uf = join_equiv_classes(n.pred, la, ra)
        cls: Dict[str, object] = {}     # group → the key class it shards
        owner: Dict[object, str] = {}   # key class → its group
        clash = {"left": set(), "right": set()}
        for side, lay in (("left", ll), ("right", rl)):
            for d, k in sorted(lay.items()):
                c = uf.find(comp_of(side, d))
                if cls.get(k, c) != c or owner.get(c, k) != k:
                    clash[side].add(d)   # a group shards one class only
                else:
                    cls[k], owner[c] = c, k
        moved = []
        for side, rel, lay, arity in (("left", lrel, ll, la), ("right", rrel, rl, ra)):
            target = {d: k for d, k in lay.items() if d not in clash[side]}
            for d in range(arity):
                k = owner.get(uf.find(comp_of(side, d)))
                if k is not None:
                    target[d] = k       # slice alike where it is whole
            moved.append(place.move(rel, lay, target))
        (lrel, _), (rrel, _) = moved
        comps = list(n.proj.comps)
        if grp is not None:
            comps = [None if isinstance(c, Lit) else comps[c.idx] for c in grp.comps]
        out_lay: Layout = {}
        partial = set()
        for k, c in cls.items():
            at = [o for o, comp in enumerate(comps)
                  if comp is not None and not isinstance(comp, Lit) and uf.find(comp) == c]
            for o in at:
                out_lay[o] = k
            if not at:
                partial.add(k)
        out = _dense_join(n, grp, lrel, rrel, dispatch, resolutions)
        return place.reduce(out, out_lay, partial)

    def join(n: fra.Join, grp: Optional[KeyFn]) -> Tuple[AnyRel, Layout]:
        (lrel, ll), (rrel, rl) = ex(n.left), ex(n.right)
        plan = place.plans.get(n.id)
        if plan is not None:
            # the operands in the layouts this join's plan names
            lrel, ll = place.move(lrel, ll, place.plan_layout(plan, "left", lrel, ll, n.left.key_arity))
            rrel, rl = place.move(rrel, rl, place.plan_layout(plan, "right", rrel, rl, n.right.key_arity))
        if isinstance(lrel, CooRelation) or isinstance(rrel, CooRelation):
            if isinstance(lrel, CooRelation) and isinstance(rrel, CooRelation):
                raise LoweringError("COO ⋈ COO not supported")
            return coo_join(n, grp, lrel, ll, rrel, rl, plan)
        return dense_join(n, grp, lrel, ll, rrel, rl)

    def _ex(n: fra.Node) -> Tuple[AnyRel, Layout]:
        if isinstance(n, (fra.TableScan, fra.Const)):
            name = n.name if isinstance(n, fra.TableScan) else n.ref
            return env[name], dict(place.layouts.get(name, {}))
        if isinstance(n, fra.Select):
            rel, lay = ex(n.child)
            if isinstance(rel, CooRelation):
                return _select_coo(n, rel), lay
            fixed, remaining, proj_idx = _select_proj(n)
            rel, lay = place.whole(rel, lay, set(fixed))
            return _select_dense(n, rel), {
                proj_idx.index(remaining.index(d)): k for d, k in lay.items()
            }
        if isinstance(n, fra.Agg):
            if not n.kernel.is_add:
                raise LoweringError("non-additive Σ not supported in compiler")
            if isinstance(n.child, fra.Join) and fuse_join_agg:
                return join(n.child, n.grp)
            rel, lay = ex(n.child)
            if isinstance(rel, CooRelation):
                out = _agg_coo(n.grp, rel, dispatch, resolutions)
                return place.reduce(out, {}, set(lay.values()))
            keep = _agg_keep(n.grp, rel.key_arity)
            out_lay = {keep.index(d): k for d, k in lay.items() if d in keep}
            partial = {k for d, k in lay.items() if d not in keep}
            return place.reduce(_agg_dense(n.grp, rel), out_lay, partial)
        if isinstance(n, fra.Join):
            return join(n, None)
        if isinstance(n, fra.Restrict):
            ref, ref_lay = ex(n.ref)
            if isinstance(ref, DenseRelation):
                return ex(n.child)
            if isinstance(n.child, fra.Join):
                (lrel, ll), (rrel, rl) = ex(n.child.left), ex(n.child.right)
                if isinstance(lrel, DenseRelation) and isinstance(rrel, DenseRelation):
                    lrel, _ = place.whole(lrel, ll)
                    rrel, _ = place.whole(rrel, rl)
                    return _restricted_join(
                        n.child, ref, lrel, rrel, dispatch, resolutions
                    ), dict(ref_lay)
            child, lay = ex(n.child)
            if isinstance(child, CooRelation):
                return child, lay
            child, _ = place.whole(child, lay)
            return _gather_at(ref, child, dispatch, resolutions), dict(ref_lay)
        if isinstance(n, fra.AddOp):
            (a, al), (b, bl) = ex(n.left), ex(n.right)
            if isinstance(a, DenseRelation) and isinstance(b, DenseRelation) and al == bl:
                return _add(a, b), al
            (a, _), (b, _) = place.whole(a, al), place.whole(b, bl)
            return _add(a, b), {}
        raise TypeError(f"unknown node {n}")

    try:
        rel, lay = ex(root)
        return place.whole(rel, lay)[0]
    finally:
        ex = None  # noqa: F841  (see _execute_graph)
