"""Static analysis over FRA programs.

- ``diagnostics``: the :class:`Diagnostic` / :class:`CheckReport` record
  types (severity, node path, message, fix hint).
- ``typecheck``: bottom-up schema/shape/dtype inference over an FRA graph;
  ``check_query`` returns a :class:`CheckReport`, and the engine runs it as
  the mandatory validate stage of ``RAEngine.lower``.
"""

from .diagnostics import CheckReport, Diagnostic
from .typecheck import ValidationError, check_query

__all__ = ["CheckReport", "Diagnostic", "ValidationError", "check_query"]
