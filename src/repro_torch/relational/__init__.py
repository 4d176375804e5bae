"""Tensor-relational ops for model code.

Each op's *forward* is an FRA query lowered by the chunked compiler, and
its *backward* is the gradient query generated by relational auto-diff
(core/autodiff.py) — wrapped in ``torch.autograd.Function`` so that model
code trained with ``torch.autograd`` runs the paper's RJP-generated plans
instead of PyTorch's own autograd through the engine.
"""

from .linear import rel_linear, rel_matmul, rel_matmul_blocked  # noqa: F401
from .gcn import gcn_conv, partitioned_edges  # noqa: F401
from .embedding import rel_embed  # noqa: F401
