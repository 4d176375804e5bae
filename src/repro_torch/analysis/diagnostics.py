"""Structured diagnostics shared by the typed FRA checker, the SQL
front end, and ``Database.explain``.

A :class:`Diagnostic` pins one finding to a *node path* — a stable,
structural address inside the query (``Σ/⋈/L:τ(edges)``) or the SQL
script (``stmt[0]/FROM``) — so tooling can point at the offending
operator rather than a trace-time stack frame. This module deliberately
imports nothing from the rest of ``repro_torch`` so that any layer (including
``core.sql``) can depend on it without cycles.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

#: Severity levels, most severe first. ``error`` means the compiled
#: path is guaranteed to reject the query; ``warning`` marks hazards
#: (silent dtype promotion, empty selections, replication fallbacks,
#: partial-RJP gradients) that execute but deserve attention.
SEVERITIES: Tuple[str, ...] = ("error", "warning", "info")


@dataclass(frozen=True)
class Diagnostic:
    """One finding: where (``node_path``), what (``message``), how bad
    (``severity``), which rule (``code``), and how to fix it (``hint``)."""

    severity: str
    code: str
    node_path: str
    message: str
    hint: str = ""

    def render(self) -> str:
        """Multi-line human rendering (the form ``CheckReport.render``
        and ``Database.explain`` emit)."""
        out = f"{self.severity}[{self.code}] {self.node_path}: {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out

    def render_inline(self) -> str:
        """Single-line rendering (used for exception messages)."""
        out = f"{self.node_path}: {self.message}"
        if self.hint:
            out += f" (hint: {self.hint})"
        return out


@dataclass(frozen=True)
class CheckReport:
    """Ordered collection of diagnostics from one check pass."""

    diagnostics: Tuple[Diagnostic, ...]

    @property
    def errors(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "error")

    @property
    def warnings(self) -> Tuple[Diagnostic, ...]:
        return tuple(d for d in self.diagnostics if d.severity == "warning")

    @property
    def ok(self) -> bool:
        """True when no *error*-severity diagnostic was produced (the
        compiled path is not statically doomed; warnings may remain)."""
        return not self.errors

    def codes(self) -> Tuple[str, ...]:
        return tuple(d.code for d in self.diagnostics)

    def render(self) -> str:
        if not self.diagnostics:
            return "ok (no diagnostics)"
        head = "ok" if self.ok else "rejected"
        lines = [
            f"{head}: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s)"
        ]
        lines += [d.render() for d in self.diagnostics]
        return "\n".join(lines)
