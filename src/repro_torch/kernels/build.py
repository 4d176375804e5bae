"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
sources at once in parallel, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, from the package's own sources, into ``build/kernels/<hash>/``
at the repository root (listed in ``.gitignore``); the hash covers every
source and flag, so an edited source builds afresh. Importing this module
builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("segsum.cu", "gather.cu", "matmul.cu", "ssm_scan.cu")
#: headers the sources include (hashed with them)
HEADERS = ("launch_record.h",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v") + ARCH_FLAGS
LIB_NAME = "librepro_torch_kernels.so"

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

#: what the last build printed (ptxas register/shared-memory report per
#: kernel) and how long it took; empty when the library was already built.
last_build: Dict[str, object] = {"seconds": 0.0, "log": "", "path": ""}


def build_root() -> Path:
    """``<repo>/build/kernels`` (src/repro_torch/kernels → repo root)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and /usr/local/cuda/bin): "
        "the CUDA kernels are built from source at first use"
    )


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(nvcc.encode())
    h.update(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]]) -> str:
    """Run the commands concurrently; raise with their output if any fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs, failed = [], []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        logs.append(out)
        if p.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return "".join(logs)


def build() -> Path:
    """Compile the sources (if this exact build is not there yet) and
    return the library's path."""
    nvcc = _nvcc()
    out_dir = build_root() / _digest(nvcc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        last_build.update(seconds=0.0, log="", path=str(lib))
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [str(Path(tmp, Path(s).stem + ".o")) for s in SOURCES]
        log = _run_all(
            [[nvcc, *FLAGS, "-c", str(CSRC / s), "-o", o] for s, o in zip(SOURCES, objs)]
        )
        staged = str(Path(tmp, LIB_NAME))
        log += _run_all([[nvcc, "-shared", *ARCH_FLAGS, "-o", staged, *objs]])
        os.replace(staged, lib)  # atomic: a concurrent build sees all or nothing
    last_build.update(seconds=time.perf_counter() - t0, log=log, path=str(lib))
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            lib.repro_segsum_starts.argtypes = [vp, ll, i32, vp, vp]
            lib.repro_segsum.argtypes = [vp, vp, vp, vp, vp, vp, ll, i32, i32, i32, vp]
            lib.repro_gather.argtypes = [vp, vp, vp, ll, i32, i32, i32, vp]
            matmuls = (lib.repro_matmul_f32, lib.repro_matmul_bf16, lib.repro_matmul_f16)
            for fn in matmuls:
                fn.argtypes = [vp, vp, vp, vp, ll, i32, i32, i32, vp]
            lib.repro_matmul_bf16_split.argtypes = [vp, vp, vp, vp, ll, i32, i32, i32, i32, vp]
            lib.repro_matmul_bf16_skinny.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp]
            lib.repro_matmul16_skinny_plan.argtypes = [i32, i32, i32, i32, i32, ctypes.POINTER(ll)]
            lib.repro_ssm_scan.argtypes = [vp, vp, vp, ll, ll, ll, i32, i32, vp]
            for fn in (lib.repro_segsum_starts, lib.repro_segsum, lib.repro_gather,
                       *matmuls, lib.repro_matmul_bf16_split, lib.repro_matmul_bf16_skinny,
                       lib.repro_matmul16_skinny_plan, lib.repro_ssm_scan):
                fn.restype = i32
            lib.repro_last_launches.argtypes = [ctypes.POINTER(i32), i32]
            lib.repro_last_launches.restype = i32
            lib.repro_error_string.argtypes = [i32]
            lib.repro_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code != 0:
        msg = library().repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
