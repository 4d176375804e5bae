"""Plain PyTorch version of the row-gather kernel."""

import torch


def gather_rows_ref(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``out[e] = table[rows[e]]``, with ids outside ``[0, N)`` (COO
    padding) giving zero rows."""
    n = table.shape[0]
    if n == 0:
        return table.new_zeros((rows.shape[0],) + tuple(table.shape[1:]))
    valid = (rows >= 0) & (rows < n)
    out = table.index_select(0, rows.clamp(0, n - 1))
    return torch.where(
        valid.reshape((-1,) + (1,) * (table.dim() - 1)),
        out,
        torch.zeros((), dtype=table.dtype, device=table.device),
    )
