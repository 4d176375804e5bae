"""Hand-written CUDA kernels for the engine's hot spots (``csrc/*.cu``),
built for Hopper (``sm_90a``) at first use by ``build.py``:

  segsum/   segment sum in one summation order, no atomics (a scan of the
            ids for few edges, a sorted CSR pass for many) — the Σ over a
            COO edge relation;
  gather/   row gather with in-kernel masking, many loads in flight and
            streaming stores — the edge ⋈ node join and the
            restricted-join gradient gathers;
  matmul/   f32 product on the CUDA cores (128-row tiles, split-K for
            m ≤ 16, one summation order) — the matmul-shaped Σ∘⋈;
  ssm_scan/ the selective scan h_t = a_t ⊙ h_{t-1} + b_t, one thread per
            lane — the Mamba blocks' recurrence (called by models/ssm.py,
            not a dispatch op of the compiler).

Each package has ``ops.py`` (the wrapper: checks, launch on the current
stream, a launch count, a ``torch.autograd.Function`` whose backward stays
in the tier) and ``ref.py`` (the plain PyTorch version, which the wrapper
takes for CPU tensors). Importing this package builds nothing.
"""

from typing import Dict

from .gather.ops import gather_rows
from .matmul.ops import blocked_matmul
from .segsum.ops import segment_sum
from .ssm_scan.ops import ssm_scan

#: kernel name (the dispatch op's, where it is one) → the wrapper that
#: counts that kernel's launches.
WRAPPERS = {
    "segment_sum": segment_sum,
    "gather_join": gather_rows,
    "blocked_matmul": blocked_matmul,
    "ssm_scan": ssm_scan,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per kernel since the counts were last reset."""
    return {op: fn.launches for op, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0
