"""Engine-invariant linter for the port: AST checks for the rules that hold
the compiler/engine contract together but that no unit test can pin down
file by file. Stdlib only:

    python -m repro_torch.analysis.lint [--root PATH]

It is the port's counterpart of the reference's ``tools/lint_invariants.py``
(which lints ``src/repro``), over ``src/repro_torch``. Each rule prints
``file:line: [rule] message``; any violation exits non-zero. The rules,
and what each maps to in the reference:

  dispatch-pairing   (reference: dispatch-pairing, with its tiers mapped)
                     every logical op in ``DISPATCH_OPS`` registers all
                     four tiers (cuda/sanitizer/ref/torch) in
                     core/kernels.py, and every kernel package
                     (kernels/*/ with an ops.py) pairs its forward with a
                     ``torch.autograd.Function`` defining ``forward`` and
                     ``backward`` (the reference's ``jax.custom_vjp`` +
                     ``defvjp``) and ships a ``ref.py`` plain version.
  kernel-contract    (the same rule) every kernel package's ops.py declares
                     a module-level ``CONTRACT = KernelContract(...)``, and
                     ``_CONTRACT_MODULES`` in core/kernels.py names a
                     contract module for every ``DISPATCH_OPS`` op — the
                     static certifier (analysis/kernelcheck.py) proves the
                     launch models from these.
  cache-key          (the same rule) the lowering-cache signature builders
                     in core/engine.py (``_rel_signature`` /
                     ``env_signature`` / ``_stats_key``) return hashable
                     shapes: no dict/list/set at the top of a return.
  jit-scope          (reference: jit-scope, which confines ``jax.jit`` to
                     the executable-owning modules) the port's steps are
                     eager, so ``torch.compile`` and ``torch.jit`` appear
                     nowhere in the package: a compiled region would
                     bypass the session's counters and the dispatch table.
  planner-pure       (reference: planner-pure, over ``jax.numpy``)
                     core/planner.py and core/rewrite.py never import
                     ``torch``: cost models and algebraic rewrites run at
                     plan time on Python numbers.
  task-retention     (the same rule) every asyncio ``create_task`` call in
                     serving/ is retained (assigned, not fire-and-forget)
                     and named.
"""

from __future__ import annotations

import argparse
import ast
import sys
from pathlib import Path
from typing import List, NamedTuple

DISPATCH_TIERS = ("cuda", "sanitizer", "ref", "torch")

# lowering-cache signature builders (rule: cache-key)
CACHE_KEY_FUNCS = ("_rel_signature", "env_signature", "_stats_key")

UNHASHABLE_NODES = (
    ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp, ast.SetComp,
)


class Violation(NamedTuple):
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _targets(node: ast.AST) -> List[ast.AST]:
    if isinstance(node, ast.Assign):
        return list(node.targets)
    if isinstance(node, ast.AnnAssign):
        return [node.target]
    return []


def _assigns(node: ast.AST, name: str) -> bool:
    return any(isinstance(t, ast.Name) and t.id == name for t in _targets(node)) and (
        getattr(node, "value", None) is not None
    )


def _dotted(node: ast.AST) -> str:
    """``a.b.c`` for an attribute chain of names, else ''."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# ---------------------------------------------------------------------------
# dispatch-pairing
# ---------------------------------------------------------------------------


def _has_autograd_function(tree: ast.Module) -> bool:
    """A class deriving from ``torch.autograd.Function`` (or ``Function``
    imported from it) that defines both ``forward`` and ``backward``."""
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if not any(_dotted(b).endswith("autograd.Function") or _dotted(b) == "Function"
                   for b in node.bases):
            continue
        methods = {f.name for f in node.body if isinstance(f, ast.FunctionDef)}
        if {"forward", "backward"} <= methods:
            return True
    return False


def check_dispatch_pairing(src: Path) -> List[Violation]:
    out: List[Violation] = []
    kern = src / "core" / "kernels.py"
    if kern.exists():
        tree = _parse(kern)
        ops: List[str] = []
        ops_line = 1
        registered = set()
        for node in ast.walk(tree):
            if _assigns(node, "DISPATCH_OPS"):
                try:
                    ops = list(ast.literal_eval(node.value))
                    ops_line = node.lineno
                except ValueError:
                    out.append(Violation(
                        str(kern), node.lineno, "dispatch-pairing",
                        "DISPATCH_OPS must be a literal tuple of op names",
                    ))
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "register_impl"
                and len(node.args) >= 2
                and all(isinstance(a, ast.Constant) for a in node.args[:2])
            ):
                registered.add((node.args[0].value, node.args[1].value))
        for op in ops:
            missing = [t for t in DISPATCH_TIERS if (op, t) not in registered]
            if missing:
                out.append(Violation(
                    str(kern), ops_line, "dispatch-pairing",
                    f"op {op!r} has no registered {'/'.join(missing)} "
                    "tier(s); every DISPATCH_OPS entry needs all of "
                    f"{'/'.join(DISPATCH_TIERS)}",
                ))

    kdir = src / "kernels"
    if kdir.is_dir():
        for ops_py in sorted(kdir.glob("*/ops.py")):
            if not _has_autograd_function(_parse(ops_py)):
                out.append(Violation(
                    str(ops_py), 1, "dispatch-pairing",
                    "kernel ops.py has no torch.autograd.Function with forward "
                    "and backward — the kernel's forward must pair with an "
                    "explicit backward",
                ))
            if not (ops_py.parent / "ref.py").exists():
                out.append(Violation(
                    str(ops_py.parent), 1, "dispatch-pairing",
                    "kernel package has no ref.py plain version for the "
                    "ref dispatch tier",
                ))
    return out


# ---------------------------------------------------------------------------
# kernel-contract
# ---------------------------------------------------------------------------


def check_kernel_contract(src: Path) -> List[Violation]:
    out: List[Violation] = []
    kdir = src / "kernels"
    if kdir.is_dir():
        for ops_py in sorted(kdir.glob("*/ops.py")):
            tree = _parse(ops_py)
            has_contract = any(
                _assigns(node, "CONTRACT")
                and isinstance(node.value, ast.Call)
                and _dotted(node.value.func).split(".")[-1] == "KernelContract"
                for node in tree.body
            )
            if not has_contract:
                out.append(Violation(
                    str(ops_py), 1, "kernel-contract",
                    "kernel ops.py declares no module-level CONTRACT = "
                    "KernelContract(...) — the static certifier "
                    "(repro_torch.analysis.kernelcheck) has nothing to prove",
                ))

    kern = src / "core" / "kernels.py"
    if kern.exists():
        tree = _parse(kern)
        ops: List[str] = []
        modules: dict = {}
        line = 1
        for node in ast.walk(tree):
            if _assigns(node, "DISPATCH_OPS"):
                try:
                    ops = list(ast.literal_eval(node.value))
                except ValueError:
                    pass
            if _assigns(node, "_CONTRACT_MODULES"):
                line = node.lineno
                try:
                    modules = dict(ast.literal_eval(node.value))
                except ValueError:
                    out.append(Violation(
                        str(kern), node.lineno, "kernel-contract",
                        "_CONTRACT_MODULES must be a literal dict of "
                        "op -> contract module path",
                    ))
        for op in ops:
            if op not in modules:
                out.append(Violation(
                    str(kern), line, "kernel-contract",
                    f"dispatch op {op!r} has no entry in "
                    "_CONTRACT_MODULES — kernelcheck cannot load its "
                    "KernelContract",
                ))
    return out


# ---------------------------------------------------------------------------
# cache-key
# ---------------------------------------------------------------------------


def check_cache_key(src: Path) -> List[Violation]:
    out: List[Violation] = []
    eng = src / "core" / "engine.py"
    if not eng.exists():
        return out
    tree = _parse(eng)
    found = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name in CACHE_KEY_FUNCS:
            found.add(node.name)
            for ret in ast.walk(node):
                if isinstance(ret, ast.Return) and isinstance(ret.value, UNHASHABLE_NODES):
                    out.append(Violation(
                        str(eng), ret.lineno, "cache-key",
                        f"{node.name} returns an unhashable "
                        f"{type(ret.value).__name__.lower()} — the "
                        "lowering cache keys on this value",
                    ))
    for name in CACHE_KEY_FUNCS:
        if name not in found:
            out.append(Violation(
                str(eng), 1, "cache-key",
                f"signature builder {name} not found — if it moved, "
                "update CACHE_KEY_FUNCS in repro_torch/analysis/lint.py",
            ))
    return out


# ---------------------------------------------------------------------------
# jit-scope
# ---------------------------------------------------------------------------


def check_jit_scope(src: Path) -> List[Violation]:
    out: List[Violation] = []
    for path in sorted(src.rglob("*.py")):
        tree = _parse(path)
        for node in ast.walk(tree):
            # torch.jit.script holds the attribute torch.jit: one hit a use
            bad = isinstance(node, ast.Attribute) and _dotted(node) in ("torch.compile", "torch.jit")
            if isinstance(node, ast.ImportFrom) and (
                (node.module == "torch" and any(a.name in ("compile", "jit") for a in node.names))
                or (node.module or "").startswith("torch.jit")
            ):
                bad = True
            if isinstance(node, ast.Import) and any(a.name.startswith("torch.jit") for a in node.names):
                bad = True
            if bad:
                out.append(Violation(
                    str(path), node.lineno, "jit-scope",
                    "torch.compile / torch.jit in the port: its steps are "
                    "eager, and a compiled region bypasses the session's "
                    "counters and the dispatch table",
                ))
    return out


# ---------------------------------------------------------------------------
# planner-pure
# ---------------------------------------------------------------------------


def check_planner_pure(src: Path) -> List[Violation]:
    out: List[Violation] = []
    for rel in ("core/planner.py", "core/rewrite.py"):
        path = src / rel
        if not path.exists():
            continue
        for node in ast.walk(_parse(path)):
            if (isinstance(node, ast.Import) and any(
                    a.name == "torch" or a.name.startswith("torch.") for a in node.names)) or (
                    isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "torch"):
                out.append(Violation(
                    str(path), node.lineno, "planner-pure",
                    "torch import in plan-time code — cost models and "
                    "rewrites must stay off the device (Python numbers only)",
                ))
    return out


# ---------------------------------------------------------------------------
# task-retention
# ---------------------------------------------------------------------------


def check_task_retention(src: Path) -> List[Violation]:
    out: List[Violation] = []
    d = src / "serving"
    if not d.is_dir():
        return out
    for path in sorted(d.glob("*.py")):
        tree = _parse(path)
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                call = (
                    child.value
                    if isinstance(child, (ast.Expr, ast.Assign, ast.Return))
                    else child
                )
                if not (
                    isinstance(call, ast.Call)
                    and isinstance(call.func, ast.Attribute)
                    and call.func.attr == "create_task"
                ):
                    continue
                if isinstance(child, ast.Expr):
                    out.append(Violation(
                        str(path), call.lineno, "task-retention",
                        "fire-and-forget create_task: the task can be "
                        "garbage-collected mid-flight and its "
                        "exceptions vanish — assign it",
                    ))
                if not any(k.arg == "name" for k in call.keywords):
                    out.append(Violation(
                        str(path), call.lineno, "task-retention",
                        "create_task without name=: unnamed scheduler "
                        "tasks are undebuggable in asyncio dumps",
                    ))
    return out


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

ALL_CHECKS = (
    check_dispatch_pairing,
    check_kernel_contract,
    check_cache_key,
    check_jit_scope,
    check_planner_pure,
    check_task_retention,
)


def run(root: Path) -> List[Violation]:
    """Every rule's violations over ``root/src/repro_torch``."""
    src = Path(root) / "src" / "repro_torch"
    violations: List[Violation] = []
    for check in ALL_CHECKS:
        violations.extend(check(src))
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint", description=__doc__.splitlines()[0]
    )
    ap.add_argument(
        "--root",
        type=Path,
        default=Path(__file__).resolve().parents[3],
        help="repo root (contains src/repro_torch); default: this checkout",
    )
    args = ap.parse_args(argv)
    violations = run(args.root)
    for v in violations:
        print(v.render())
    if violations:
        print(f"{len(violations)} invariant violation(s)")
        return 1
    print("engine invariants ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
