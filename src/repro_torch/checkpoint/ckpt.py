"""Checkpointing: one flat npz of (params, opt_state, step), in the
reference's layout, so a checkpoint written by either package restores in
the other.

The file is ``<dir>/step_<n>_shard_0.npz``; its keys are the reference's
pytree paths: ``params/<path>``, ``opt/mu/<path>``, ``opt/nu/<path>`` and
``opt/step``, where ``<path>`` is a parameter's name with "/" for "." and
each stage's repeated superblocks stacked on a leading axis
(``params/stages/0/scan/0:moe/attn/wq`` holds every repeat's ``wq``, the
port's ``stages.0.scan.<r>.0:moe.attn.wq``), and whisper's encoder layers
likewise (``params/encoder/attn/wq``, the port's ``encoder.<r>.attn.wq``).
Arrays are copied to the host
before writing. A bf16 tensor (llama3's Adam moments) is stored as the
reference's numpy writes its bf16 arrays: 2-byte void entries holding the
bf16 bits, which numpy alone cannot cast; restoring reads the bits back.
(The reference's own restore cannot cast them: ROADMAP.md §3.)"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch


def _ref_key(name: str) -> Tuple[str, Optional[int]]:
    """A parameter name's key in the reference's pytree, and its repeat
    (None outside a stage's stacked superblocks and the stacked encoder
    layers)."""
    parts = name.split(".")
    if len(parts) > 4 and parts[0] == "stages" and parts[2] == "scan":
        return "/".join(parts[:3] + parts[4:]), int(parts[3])
    if len(parts) > 2 and parts[0] == "encoder":
        return "/".join(parts[:1] + parts[2:]), int(parts[1])
    return "/".join(parts), None


def _arrays(named: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    stacks: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in named.items():
        key, r = _ref_key(name)
        t = t.detach().cpu()
        arr = t.view(torch.int16).numpy().view("V2") if t.dtype == torch.bfloat16 else t.numpy()
        if r is None:
            out[prefix + key] = arr
        else:
            stacks.setdefault(prefix + key, {})[r] = arr
    for key, rows in stacks.items():
        out[key] = np.stack([rows[r] for r in range(len(rows))])
    return out


def save_checkpoint(directory: str, step: int, params, opt_state) -> str:
    """Write ``params`` (name → tensor) and ``opt_state`` (Adam's ``mu``,
    ``nu`` and ``step``); returns the file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}_shard_0.npz")
    arrays = _arrays(params, "params/")
    for moment in ("mu", "nu"):
        arrays.update(_arrays(opt_state[moment], f"opt/{moment}/"))
    arrays["opt/step"] = np.asarray(int(opt_state["step"]), np.int32)
    np.savez(path, **arrays)
    return path


def _fill(data, template: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for name, t in template.items():
        key, r = _ref_key(name)
        arr = data[prefix + key]
        if r is not None:
            arr = arr[r]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{prefix + key}: shape {arr.shape} in the checkpoint, "
                             f"{tuple(t.shape)} in the template")
        if arr.dtype.kind == "V":  # bf16 bits
            out[name] = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16).to(
                dtype=t.dtype, device=t.device)
        else:
            out[name] = torch.tensor(arr, dtype=t.dtype, device=t.device)
    return out


def restore_checkpoint(path: str, params_template, opt_template):
    """Restore into the templates' structure, dtypes and devices (shapes
    must match): (params, opt_state)."""
    with np.load(path) as data:
        params = _fill(data, params_template, "params/")
        opt = {m: _fill(data, opt_template[m], f"opt/{m}/") for m in ("mu", "nu")}
        opt["step"] = int(data["opt/step"])
    return params, opt
