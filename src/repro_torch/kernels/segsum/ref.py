"""Plain PyTorch version of the segment-sum kernel."""

import torch


def segment_sum_ref(msg: torch.Tensor, seg: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_e [seg_e = s]·msg[e]`` over ``num_segments`` rows, in
    ``msg``'s dtype. Ids outside ``[0, num_segments)`` (the COO padding id
    -1 among them) are dropped."""
    out = msg.new_zeros((num_segments,) + tuple(msg.shape[1:]))
    if num_segments == 0 or msg.shape[0] == 0:
        return out
    valid = (seg >= 0) & (seg < num_segments)
    vals = torch.where(
        valid.reshape((-1,) + (1,) * (msg.dim() - 1)), msg, torch.zeros((), dtype=msg.dtype, device=msg.device)
    )
    return out.index_add_(0, seg.clamp(0, num_segments - 1), vals)
