"""Plain PyTorch version of the selective-scan kernel.

It is the time loop, not the associative scan of the reference's oracle:
the loop is the recurrence as written, in the kernel's own order of
operations (``a_t * h`` rounded, then ``+ b_t`` rounded, the state in f32),
so the kernel and this version agree bit for bit and a check on the card
needs no tolerance for a different summation tree. It holds one state and
the output, where a parallel prefix holds several full-size temporaries.
(The associative scan is ``models/ssm.py::_assoc_scan``, the model's own
path when ``ssm_pallas`` is off.)
"""

import torch


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """``h_t = a_t ⊙ h_{t-1} + b_t`` along axis 1, ``h_{-1} = 0``; with
    ``reverse`` the walk runs from the last step to the first. The state is
    f32; each ``h_t`` is stored in ``a``'s dtype."""
    h = torch.empty_like(a)
    state = a.new_zeros(a.shape[:1] + a.shape[2:], dtype=torch.float32)
    steps = range(a.shape[1] - 1, -1, -1) if reverse else range(a.shape[1])
    for t in steps:
        state = a[:, t].float() * state + b[:, t].float()
        h[:, t] = state
    return h
