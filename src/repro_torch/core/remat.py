"""Saved products for rematerialization under the "dots" policy.

The reference rematerializes a superblock with ``jax.checkpoint`` under
``jax.checkpoint_policies.dots_saveable``: the backward runs the superblock
again, but takes the output of every product (each ``dot_general``) from
the first run instead of computing it anew. PyTorch's selective-checkpoint
policies see aten ops only, and the CUDA products behind ``rel_linear`` are
not aten ops, so the port keeps the products' outputs itself.

Every product of the model computes its output through ``product(compute,
key)``: ``rel_linear``'s (``relational/linear.py``) and the blocks' einsums
(``models/common.py::einsum``). While a ``ProductStore`` records (the
checkpointed forward), each output is kept in call order; while it replays
(the recompute in the backward), the call at each position hands back the
output kept there and computes nothing. ``key`` names the call (the
product and its operands' shapes) and must match at replay. The
``autograd.Function`` around each call saves the same tensors either way,
so the backward, and the gradients, equal the "nothing" policy's bit for
bit. Outside a store ``product`` just computes.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Hashable, List, Optional, Tuple

import torch

_STORE: "contextvars.ContextVar[Optional[ProductStore]]" = contextvars.ContextVar(
    "repro_torch_product_store", default=None
)


class ProductStore:
    """The product outputs of one checkpointed call, in call order."""

    def __init__(self):
        self.outputs: List[Tuple[Hashable, torch.Tensor]] = []
        self.replaying = False
        self.position = 0

    @contextlib.contextmanager
    def _active(self, replaying: bool):
        self.replaying, self.position = replaying, 0
        token = _STORE.set(self)
        try:
            yield self
        finally:
            _STORE.reset(token)

    def record(self):
        """The context of the first run: keep every product's output."""
        self.outputs = []
        return self._active(False)

    def replay(self):
        """The context of the recompute: hand the kept outputs back."""
        return self._active(True)

    def take(self, compute: Callable[[], torch.Tensor], key: Hashable) -> torch.Tensor:
        if not self.replaying:
            out = compute()
            self.outputs.append((key, out.detach()))
            return out
        if self.position >= len(self.outputs):
            raise RuntimeError(f"remat 'dots': the recompute calls {key!r} beyond the "
                               f"{len(self.outputs)} products of the first run")
        kept_key, out = self.outputs[self.position]
        if kept_key != key:
            raise RuntimeError(f"remat 'dots': product {self.position} of the recompute is "
                               f"{key!r}, the first run's was {kept_key!r}")
        self.position += 1
        return out.detach()


def product(compute: Callable[[], torch.Tensor], key: Hashable) -> torch.Tensor:
    """``compute()``, kept or handed back by the active ``ProductStore``."""
    store = _STORE.get()
    return compute() if store is None else store.take(compute, key)
