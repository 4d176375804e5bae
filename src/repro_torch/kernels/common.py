"""What every kernel wrapper shares: where a tensor sends a call, the checks
before a launch, the launch itself on PyTorch's current stream, and the
launch record of the last call (``last_launches``).

A small call's cost is the host's, so the launch path holds only what a
launch needs: each C entry point is bound once and kept here (no lock per
call), a tensor's checks are one test on the way through, the stream is
PyTorch's raw handle (no ``torch.cuda.Stream`` object per call), and the
device is switched only when the tensor's is not the current one.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import build

#: the kernel library's C entry points, bound at first use
_ENTRIES: Dict[str, object] = {}


def on_cpu(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True when the call takes the plain version: both tensors lie on the
    CPU. CUDA tensors launch the kernel; any other device raises."""
    if a.is_cuda and b.is_cuda:
        return False
    if a.device.type == "cpu" and b.device.type == "cpu":
        return True
    raise ValueError(
        "kernel inputs must all lie on the CPU or all on one CUDA device; got "
        f"{sorted({a.device.type, b.device.type})}"
    )


def require(name: str, t: torch.Tensor, dtypes, ndim: int, what: str) -> None:
    """Raise unless ``t`` is what the kernel takes: a dtype in ``dtypes``
    (one dtype or a collection), ``ndim`` dims, contiguous. The caller has
    placed it on a CUDA device (``on_cpu`` is false)."""
    allowed = (dtypes,) if isinstance(dtypes, torch.dtype) else dtypes
    if t.dtype in allowed and t.dim() == ndim and t.is_contiguous():
        return
    if t.dtype not in allowed:
        names = [str(d).replace("torch.", "") for d in allowed]
        names = ", ".join(names[:-1]) + " or " + names[-1] if len(names) > 1 else names[0]
        raise TypeError(f"{name}: {what} must be {names}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {what} must have {ndim} dims, got shape {tuple(t.shape)}")
    raise ValueError(f"{name}: {what} must be contiguous")


def launch(name: str, fn_name: str, on: torch.Tensor, *args) -> None:
    """Call one C entry point of the kernel library on the current stream of
    the device that ``on`` lies on, and raise if it reports a CUDA error."""
    fn = _ENTRIES.get(fn_name)
    if fn is None:
        fn = _ENTRIES[fn_name] = getattr(build.library(), fn_name)
    index, current = on.get_device(), torch._C._cuda_getDevice()
    if index == current:
        code = fn(*args, torch._C._cuda_getCurrentRawStream(current))
    else:
        with torch.cuda.device(index):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if code:
        build.check(code, name)


#: the launch record's kernel codes (csrc/launch_record.h, KernelCode)
KERNEL_NAMES = {
    1: "segsum_scan", 2: "segsum_starts", 3: "segsum_chunk", 4: "segsum_combine",
    5: "gather", 6: "matmul_tiled", 7: "matmul_skinny", 8: "matmul_reduce", 9: "ssm_scan",
}
#: launches a record holds (kMaxLaunches) and ints per launch (kLaunchInts)
_MAX_LAUNCHES, _LAUNCH_INTS = 4, 8

Launch = Tuple[str, Tuple[int, int, int], Tuple[int, int, int]]


def last_launches() -> Tuple[Launch, ...]:
    """What the last kernel call launched, from the library's launch
    record: ``(kernel, gridDim, blockDim)`` per launch in order, ``kernel``
    being ``"<name>.<variant>"`` (the variant: a lane's unit in bytes for
    the gather and the segment sum's sum kernels, the tile's columns for
    the tiled product, the lanes per entry for the ordered reduce, 1 for
    the scan's reverse walk, else 0) — what a contract's
    ``core.kernels.model_launches`` gives for the call's site. Reading it
    costs no synchronisation. Raises when a call launched more kernels
    than the record holds."""
    buf = (ctypes.c_int * (_MAX_LAUNCHES * _LAUNCH_INTS))()
    n = build.library().repro_last_launches(buf, _MAX_LAUNCHES)
    if n > _MAX_LAUNCHES:
        raise RuntimeError(f"the last call made {n} launches; the record holds {_MAX_LAUNCHES}")
    out = []
    for i in range(n):
        e = buf[i * _LAUNCH_INTS:(i + 1) * _LAUNCH_INTS]
        out.append((f"{KERNEL_NAMES[e[0]]}.{e[1]}", tuple(e[2:5]), tuple(e[5:8])))
    return tuple(out)
