"""Carry weights and state across from the JAX package.

The reference package's parameters and relations cross as numpy arrays
(anything ``np.array`` accepts): a parameter dict such as ``{"w1", "w2"}``,
or a relation's ``data`` / ``keys`` / ``values`` / ``extents``. These
functions turn them into this package's tensors and relations on a given
device, so both packages can be fed the same state. Keys stay int32.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.relation import CooRelation, DenseRelation


def tensor(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of the array ``a`` as a tensor on ``device``."""
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def params(arrays: Mapping[str, object], device) -> Dict[str, torch.Tensor]:
    """A parameter dict (name → array) as tensors on ``device``."""
    return {k: tensor(v, device) for k, v in arrays.items()}


def dense_relation(data, key_arity: int, device) -> DenseRelation:
    """A DenseRelation from its ``data`` array and key arity."""
    return DenseRelation(tensor(data, device), key_arity)


def coo_relation(keys, values, extents: Sequence[int], device) -> CooRelation:
    """A CooRelation from its ``keys`` (int32), ``values`` and ``extents``."""
    return CooRelation(
        tensor(keys, device, torch.int32),
        tensor(values, device),
        tuple(int(e) for e in extents),
    )


def relation(rel, device):
    """A relation of the reference package (or any object with the same
    fields: ``data``/``key_arity``, or ``keys``/``values``/``extents``) as
    this package's relation on ``device``."""
    if hasattr(rel, "data"):
        return dense_relation(rel.data, rel.key_arity, device)
    return coo_relation(rel.keys, rel.values, rel.extents, device)
