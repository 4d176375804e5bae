"""Static plan certification: *prove* plan properties from the compile
records instead of observing them at runtime.

The port certifies mesh-less plans (one device, in core or streamed in
waves). Its sections ``reshard`` and ``divisibility`` are proven
trivially, as the reference proves them for a mesh-less plan; the mesh
half of the certifier (``_certify_reshard``, ``_certify_divisibility``)
waits for multi-device planning (ROADMAP.md, queue 1 item 4), and a plan
on a mesh raises ``NotImplementedError``.

``certify(compiled, env, ...)`` inspects a ``Compiled`` (or
``StreamedCompiled``) together with the environment it will run over and
emits a :class:`Certificate` asserting, section by section:

- ``reshard``: zero-unplanned-reshard execution — every committed input
  layout either equals the planned spec, or the move was recorded in the
  plan's rechunk stage (``Compiled.rechunks``, priced at plan time). The
  proof re-derives the committed-vs-planned comparison that
  ``Compiled.__call__`` performs dynamically (and warns about), so a CI
  lane can assert it *before* paying an execution.
- ``divisibility``: every sharded block dim of the effective input
  shardings divides by the mesh axes placed on it, and COO nnz padding
  targets are exactly the next shard multiple. Planner intents the
  sharding stage had to drop (replication fallbacks) are reported.
- ``coo``: owner-partition soundness of COO inputs — ``shard_offsets``
  monotone and consistent with the owner-key column (each shard's first
  real owner key matches its recorded offset).
- ``waves`` (streamed plans): re-derives ``plan_waves``' soundness as an
  independent cross-check — boundary monotonicity/coverage, owner-run
  alignment of COO wave cuts, and the resident+one-wave ≤ budget sizing.
- ``grad`` (when an FRA query + wrt names are given): RJP derivability
  per join side, ahead of compiling the gradient — ``full_rjp`` is False
  when some wrt input sits below a join whose side key is not solvable
  from its output key (the general partial-RJP fallback).
- ``kernels``: kernel-contract certification of every dispatch site the
  plan resolved (``certify_kernels`` — grid/write-race soundness, VJP
  pairing, predicate determinism; see ``analysis.kernelcheck``), cached
  on the underlying ``Lowered``.

The certificate is machine-readable (``to_dict``) and human-renderable
(``render``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ..core import fra
from ..core.keys import solve_left_key
from ..core.relation import COO_PAD_KEY, CooRelation
from .typecheck import _mirror_join


@dataclass
class Certificate:
    """Machine-readable proof record for one compiled plan."""

    kind: str  # "in-core" | "streamed"
    reshard: Dict[str, object] = field(default_factory=dict)
    divisibility: Dict[str, object] = field(default_factory=dict)
    coo: Dict[str, object] = field(default_factory=dict)
    waves: Optional[Dict[str, object]] = None
    grad: Optional[Dict[str, object]] = None
    kernels: Optional[Dict[str, object]] = None

    @property
    def zero_unplanned_reshard(self) -> bool:
        return bool(self.reshard.get("proven_zero_unplanned", True))

    @property
    def ok(self) -> bool:
        parts = [
            self.zero_unplanned_reshard,
            self.divisibility.get("ok", True),
            self.coo.get("ok", True),
        ]
        if self.waves is not None:
            parts.append(self.waves.get("ok", False))
        if self.kernels is not None:
            parts.append(self.kernels.get("ok", True))
        return all(bool(p) for p in parts)

    def to_dict(self) -> Dict[str, object]:
        return {
            "kind": self.kind,
            "ok": self.ok,
            "reshard": self.reshard,
            "divisibility": self.divisibility,
            "coo": self.coo,
            "waves": self.waves,
            "grad": self.grad,
            "kernels": self.kernels,
        }

    def render(self) -> str:
        lines = [f"certificate ({self.kind}): {'OK' if self.ok else 'FAILED'}"]
        lines.append(
            "  zero-unplanned-reshard: "
            + ("proven" if self.zero_unplanned_reshard else "VIOLATED")
        )
        for name, rec in sorted(self.reshard.get("relations", {}).items()):
            lines.append(
                f"    {name}: {rec['status']} "
                f"(planned={rec['planned']}, committed={rec['committed']})"
            )
        lines.append(
            "  divisibility: "
            + ("ok" if self.divisibility.get("ok", True) else "VIOLATED")
        )
        for item in self.divisibility.get("fallbacks", []):
            lines.append(f"    fallback: {item}")
        lines.append("  coo: " + ("ok" if self.coo.get("ok", True) else "VIOLATED"))
        if self.waves is not None:
            w = self.waves
            lines.append(
                f"  waves: {'ok' if w.get('ok') else 'VIOLATED'} "
                f"(num_waves={w.get('num_waves')}, "
                f"max_wave_bytes={w.get('max_wave_bytes')}, "
                f"budget={w.get('budget')})"
            )
        if self.grad is not None:
            lines.append(
                "  grad: "
                + ("full RJP" if self.grad.get("full_rjp") else "partial RJP")
            )
            for jp, rec in sorted(self.grad.get("joins", {}).items()):
                lines.append(f"    {jp}: {rec}")
        if self.kernels is not None:
            k = self.kernels
            lines.append(
                f"  kernels: {'ok' if k.get('ok') else 'VIOLATED'} "
                f"({k.get('sites', 0)} dispatch site(s), "
                f"{k.get('errors', 0)} error(s))"
            )
            for code in k.get("codes", []):
                lines.append(f"    {code}")
        return "\n".join(lines)


def _np(t) -> np.ndarray:
    """A tensor (on any device) or an array as a numpy array."""
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def _certify_coo(env) -> Dict[str, object]:
    out: Dict[str, object] = {"ok": True, "relations": {}}
    for name, rel in env.items():
        if not isinstance(rel, CooRelation) or rel.shard_offsets is None:
            continue
        offs = np.asarray(rel.shard_offsets)
        owners = _np(rel.keys)[:, rel.owner_dim]
        nnz = owners.shape[0]
        num = len(offs)
        rec = {"owner_dim": int(rel.owner_dim), "num_shards": num}
        rec["offsets_monotone"] = bool(np.all(np.diff(offs) >= 0))
        consistent = nnz % num == 0
        if consistent:
            per = nnz // num
            extent = int(rel.extents[rel.owner_dim])
            for s in range(num):
                first = owners[s * per]
                want = int(offs[s])
                if first == COO_PAD_KEY:
                    # all-pad shard: sentinel offset = owner extent
                    if want != extent:
                        consistent = False
                        break
                elif int(first) != want:
                    consistent = False
                    break
                # rows must be owner-sorted within/across shards
            real = owners[owners != COO_PAD_KEY]
            if consistent and real.size:
                consistent = bool(np.all(np.diff(real) >= 0))
        rec["offsets_consistent"] = bool(consistent)
        rec["ok"] = rec["offsets_monotone"] and rec["offsets_consistent"]
        if not rec["ok"]:
            out["ok"] = False
        out["relations"][name] = rec
    return out


def _certify_waves(streamed, env) -> Dict[str, object]:
    from ..core.planner import _rel_bytes

    plan = streamed.plan
    sizes = {name: _rel_bytes(rel) for name, rel in env.items()}
    streamed_names = set(plan.streamed_names)
    resident = sum(b for n, b in sizes.items() if n not in streamed_names)

    srel = env[plan.stream]
    rows = (
        int(srel.nnz)
        if isinstance(srel, CooRelation)
        else int(srel.extents[0])
    )
    b = tuple(plan.boundaries)
    boundaries_ok = (
        len(b) == plan.num_waves + 1
        and b[0] == 0
        and b[-1] == rows
        and all(b[i] < b[i + 1] for i in range(len(b) - 1))
    )

    # owner-run alignment: no COO Σ-segment may straddle a wave cut
    owner_aligned_ok = True
    if plan.owner_aligned and isinstance(srel, CooRelation):
        owners = _np(srel.keys)[:, srel.owner_dim]
        for cut in b[1:-1]:
            if owners[cut - 1] == owners[cut] != COO_PAD_KEY:
                owner_aligned_ok = False
                break

    # independent sizing check, re-deriving plan_waves' invariant: the
    # moving bytes split across num_waves waves must fit the headroom
    # left by the resident relations (owner-aligned snapping can skew an
    # individual wave past the average — max_wave_bytes reports the
    # actual worst wave; co-streams slice by the stream's row fractions)
    moving = sum(sizes.get(n, 0.0) for n in plan.streamed_names)
    max_wave = 0.0
    for w in range(plan.num_waves):
        frac = (b[w + 1] - b[w]) / rows if rows else 0.0
        max_wave = max(max_wave, moving * frac)
    budget_ok = (
        plan.num_waves >= 2
        and resident + moving / plan.num_waves <= plan.budget + 1e-9
    )

    ok = boundaries_ok and owner_aligned_ok and budget_ok
    return {
        "ok": ok,
        "num_waves": int(plan.num_waves),
        "boundaries_ok": boundaries_ok,
        "owner_aligned_ok": owner_aligned_ok,
        "budget_ok": budget_ok,
        "resident_bytes": float(resident),
        "max_wave_bytes": float(max_wave),
        "budget": float(plan.budget),
    }


def certify_grad(query, wrt: Tuple[str, ...]) -> Dict[str, object]:
    """RJP grad-derivability report for ``wrt`` inputs of an FRA query,
    computable before any compile: per join (identified by a structural
    path), whether each side's input key is solvable from the output key
    (``solvable``) or needs the general partial-RJP fallback
    (``partial``). ``full_rjp`` is True iff no wrt input needs the
    fallback."""
    root = query.root if isinstance(query, fra.Query) else query
    wrt_set = set(wrt)
    joins: Dict[str, Dict[str, str]] = {}
    full = True

    def walk(n: fra.Node, prefix: str):
        label = {
            fra.TableScan: lambda: f"τ({n.name})",
            fra.Const: lambda: f"const({n.ref})",
            fra.Select: lambda: "σ",
            fra.Agg: lambda: "Σ",
            fra.Join: lambda: "⋈",
            fra.AddOp: lambda: "+",
        }.get(type(n), lambda: "restrict")()
        sep = "" if not prefix or prefix.endswith(":") else "/"
        path = prefix + sep + label
        if isinstance(n, fra.Join):
            nonlocal full
            la, ra = n.left.key_arity, n.right.key_arity
            mpred, mproj = _mirror_join(n.pred, n.proj)
            rec = {}
            for side, child, pred, proj, sa, oa in (
                ("left", n.left, n.pred, n.proj, la, ra),
                ("right", n.right, mpred, mproj, ra, la),
            ):
                below = {s.name for s in child.table_scans()} & wrt_set
                if not below:
                    rec[side] = "n/a"
                    continue
                solvable = solve_left_key(pred, proj, sa, oa) is not None
                rec[side] = "solvable" if solvable else "partial"
                if not solvable:
                    full = False
            joins[path] = rec
            walk(n.left, path + "/L:")
            walk(n.right, path + "/R:")
        else:
            for i, c in enumerate(n.children):
                p = path + ("/L:" if i == 0 else "/R:") if len(n.children) > 1 else path
                walk(c, p)

    walk(root, "")
    return {"full_rjp": full, "joins": joins}


def certify_kernels(compiled, *, recheck: bool = False):
    """Kernel-contract certification of the dispatch sites one compiled
    plan resolved (re-exported from :mod:`repro_torch.analysis.kernelcheck`):
    grid/write-race soundness at the recorded shapes, VJP pairing,
    predicate determinism + resolution replay. Returns a
    :class:`~repro.analysis.diagnostics.CheckReport`."""
    from .kernelcheck import certify_kernels as _ck

    return _ck(compiled, recheck=recheck)


def _kernels_section(compiled) -> Dict[str, object]:
    from .kernelcheck import _lowered_of
    from .kernelcheck import certify_kernels as _ck

    report = _ck(compiled)
    resolutions = getattr(_lowered_of(compiled), "resolutions", {})
    return {
        "ok": report.ok,
        "sites": len(getattr(resolutions, "sites", ())),
        "errors": len(report.errors),
        "warnings": len(report.warnings),
        "codes": sorted(set(report.codes())),
    }


def certify(
    compiled,
    env: Dict[str, object],
    *,
    committed: Optional[Dict[str, object]] = None,
    query=None,
    wrt: Tuple[str, ...] = (),
) -> Certificate:
    """Certify a compiled plan against the environment it will execute.

    ``compiled`` is a ``Compiled`` or ``StreamedCompiled``;
    ``query``/``wrt`` additionally attach the grad-derivability section.
    ``committed`` (the committed layouts of a plan on a mesh) is accepted
    for the reference's signature; a plan on a mesh raises
    ``NotImplementedError``: the port has no multi-device planning yet."""
    from ..core.engine import Compiled, StreamedCompiled

    if getattr(compiled, "mesh", None) is not None or committed:
        raise NotImplementedError(
            "certify: plans on a mesh (reshard and divisibility proofs) wait "
            "for multi-device planning (ROADMAP.md, queue 1 item 4)"
        )
    grad = None
    if query is not None:
        grad = certify_grad(query, wrt or getattr(query, "inputs", ()))
    if not isinstance(compiled, (Compiled, StreamedCompiled)):
        raise TypeError(f"cannot certify {type(compiled).__name__}")
    kernels_section = _kernels_section(compiled)
    meshless = {
        "proven_zero_unplanned": True,
        "relations": {},
        "reason": "mesh-less plan: no device_put stage, nothing can move",
    }

    if isinstance(compiled, StreamedCompiled):
        cert = Certificate(kind="streamed", grad=grad, kernels=kernels_section)
        cert.waves = _certify_waves(compiled, env)
        cert.coo = _certify_coo(env)
        return cert

    cert = Certificate(kind="in-core", grad=grad, kernels=kernels_section)
    cert.reshard = meshless
    cert.coo = _certify_coo(env)
    return cert
