"""Static analysis over FRA programs, compiled plans and the kernels.

- ``diagnostics``: the :class:`Diagnostic` / :class:`CheckReport` record
  types (severity, node path, message, fix hint).
- ``typecheck``: bottom-up schema/shape/dtype inference over an FRA graph;
  ``check_query`` returns a :class:`CheckReport`, and the engine runs it as
  the mandatory validate stage of ``RAEngine.lower``.
- ``certify``: static certificates over a mesh-less ``Compiled`` /
  ``StreamedCompiled`` plan — COO owner-partition soundness, wave
  soundness, partial-RJP grad derivability and the kernel sites.
- ``kernelcheck``: static certification of the kernel dispatch registry
  against the packages' ``KernelContract``s — launch-model soundness of
  the CUDA launches, VJP tier pairing and dispatch-predicate determinism;
  ``certify_kernels`` proves exactly the sites a compiled plan resolved,
  ``certify_registry`` sweeps the whole registry (``python -m
  repro_torch.analysis.kernelcheck``).
- ``lint``: the engine invariants as AST checks (``python -m
  repro_torch.analysis.lint``).
"""

from .diagnostics import CheckReport, Diagnostic
from .typecheck import ValidationError, check_query
from .certify import Certificate, certify, certify_kernels
from .kernelcheck import certify_registry

__all__ = [
    "CheckReport",
    "Diagnostic",
    "ValidationError",
    "check_query",
    "Certificate",
    "certify",
    "certify_kernels",
    "certify_registry",
]
