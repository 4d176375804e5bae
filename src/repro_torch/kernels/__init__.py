"""Hand-written CUDA kernels for the engine's hot spots (``csrc/*.cu``),
built for Hopper (``sm_90a``) at first use by ``build.py``:

  segsum/   segment sum by f32 atomics — the Σ over a COO edge relation;
  gather/   row gather with in-kernel masking — the edge ⋈ node join and
            the restricted-join gradient gathers;
  matmul/   tiled f32 product on the CUDA cores — the matmul-shaped Σ∘⋈.

Each package has ``ops.py`` (the wrapper: checks, launch on the current
stream, a launch count, a ``torch.autograd.Function`` whose backward stays
in the tier) and ``ref.py`` (the plain PyTorch version, which the wrapper
takes for CPU tensors). Importing this package builds nothing.
"""

from typing import Dict

from .gather.ops import gather_rows
from .matmul.ops import blocked_matmul
from .segsum.ops import segment_sum

#: dispatch op name → the wrapper that counts that op's kernel launches.
WRAPPERS = {
    "segment_sum": segment_sum,
    "gather_join": gather_rows,
    "blocked_matmul": blocked_matmul,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per dispatch op since the counts were last reset."""
    return {op: fn.launches for op, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
