"""Carry weights and state across from the JAX package.

The reference package's parameters and relations cross as numpy arrays
(anything ``np.array`` accepts): a parameter dict such as ``{"w1", "w2"}``,
or a relation's ``data`` / ``keys`` / ``values`` / ``extents``. These
functions turn them into this package's tensors and relations on a given
device, so both packages can be fed the same state. Keys stay int32.

For the language models, ``lm_params`` loads the reference's parameter
pytree into a ``models.Model`` and ``lm_caches`` turns its prefill/decode
caches into the port's layout: the reference stacks each stage's repeated
superblocks on a leading axis (for ``jax.lax.scan``), the port keeps one
module, and one cache entry, per repeat.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from .core.relation import CooRelation, DenseRelation


def _host(a) -> torch.Tensor:
    """A CPU tensor holding a copy of the array ``a``. A bf16 array (numpy
    knows the type only through ``ml_dtypes``, whose arrays torch cannot
    read) crosses by its bits, as ``checkpoint/ckpt.py`` reads them: viewed
    as int16, then as ``torch.bfloat16``."""
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


def tensor(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A copy of the array ``a`` as a tensor on ``device`` (bf16 arrays
    bit for bit)."""
    return _host(a).to(device=device, dtype=dtype)


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


# ---------------------------------------------------------------------------
# Language models
# ---------------------------------------------------------------------------


def _unstack(tree, r: int):
    """Entry ``r`` of every leaf's leading axis."""
    if isinstance(tree, Mapping):
        return {k: _unstack(v, r) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unstack(v, r) for v in tree]
    return np.asarray(tree)[r]


def _assign(target, tree, path: str, done: set) -> None:
    """Copy the arrays of ``tree`` into the parameters of ``target`` (a
    module addressed by key or index, or a parameter), checking shapes;
    the id of each parameter written goes into ``done``."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            child = target[k] if hasattr(target, "__getitem__") else getattr(target, k)
            _assign(child, v, f"{path}.{k}", done)
    elif isinstance(tree, (list, tuple)):
        if len(tree) != len(target):
            raise ValueError(f"{path}: {len(tree)} entries for {len(target)}")
        for i, v in enumerate(tree):
            _assign(target[i], v, f"{path}[{i}]", done)
    else:
        arr = np.asarray(tree)
        if tuple(arr.shape) != tuple(target.shape):
            raise ValueError(f"{path}: shape {arr.shape} for a parameter of {tuple(target.shape)}")
        target.copy_(_host(arr))
        done.add(id(target))


def reference_leaf(name: str):
    """Where a port parameter ``name`` (``Model.named_parameters()``'s) sits
    in the reference's tree: ``(path, repeat, stacked)``. ``path`` is the
    reference's "/"-joined path, ``repeat`` the index on the leading axis
    of the reference's leaf that ``lm_params`` unstacks into this one (None
    where nothing is stacked), and ``stacked`` whether the reference treats
    that axis as a layer axis (its stage ``scan`` leaves; whisper's stacked
    ``encoder`` leaves it does not, ``launch/sharding.py``)."""
    parts = name.split(".")
    if parts[0] == "stages" and parts[2] == "scan":
        return "/".join(parts[:3] + parts[4:]), int(parts[3]), True
    if parts[0] == "encoder":
        return "/".join(parts[:1] + parts[2:]), int(parts[1]), False
    return "/".join(parts), None, False


def lm_params(model, jax_params: Mapping[str, Any]):
    """Load the reference's LM parameter pytree (numpy arrays, or anything
    ``np.asarray`` accepts) into ``model`` in place; returns the model.
    ``params["stages"][si]["scan"]``'s leading repeat axis is unstacked into
    ``model.stages[si]["scan"][r]``, and whisper's ``params["encoder"]``
    (stacked on a leading axis of ``encoder_layers``) into
    ``model.encoder[r]``. A parameter of the model that the
    tree does not fill (one the reference's model lacks, which would keep
    its random value) raises, by name."""
    done: set = set()
    with torch.no_grad():
        for name, value in jax_params.items():
            if name == "encoder":
                layers = model.encoder
                if _repeats(value) != len(layers):
                    raise ValueError(f"encoder: {_repeats(value)} layers for {len(layers)}")
                for r, layer in enumerate(layers):
                    _assign(layer, _unstack(value, r), f"encoder[{r}]", done)
            elif name != "stages":
                _assign(getattr(model, name), value, name, done)
        for si, stage in enumerate(jax_params["stages"]):
            for r, sblock in enumerate(model.stages[si]["scan"]):
                _assign(sblock, _unstack(stage["scan"], r), f"stages[{si}].scan[{r}]", done)
            _assign(model.stages[si]["tail"], stage["tail"], f"stages[{si}].tail", done)
    missed = [name for name, p in model.named_parameters() if id(p) not in done]
    if missed:
        raise ValueError(f"{len(missed)} parameters of the model have no array in the "
                         f"reference's tree: {', '.join(missed)}")
    return model


def _tensors(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return tensor(tree, device)


def _repeats(tree) -> int:
    while isinstance(tree, (Mapping, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, Mapping) else tree[0]
    return int(np.asarray(tree).shape[0])


def lm_caches(jax_caches: Sequence[Mapping[str, Any]], device) -> List[Dict[str, Any]]:
    """The reference's LM caches (a list per stage of ``{"scan": stacked
    entries, "tail": [entries]}``, numpy arrays) in ``models.Model``'s
    layout on ``device``: one entry per repeat."""
    out = []
    for stage in jax_caches:
        scan = stage["scan"]
        out.append({
            "scan": [_tensors(_unstack(scan, r), device) for r in range(_repeats(scan))],
            "tail": _tensors(stage["tail"], device),
        })
    return out
