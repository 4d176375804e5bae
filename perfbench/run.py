"""Run one cell of the benchmark once, on the GPU:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result, one JSON object (``perfbench/harness.py``); the numbers compared
with the reference, each beside its limit, are the last lines of standard
error. The run exits with another code than 0, and prints no result,
where there is no H100 (or too few for the cell), where the program is
not in the checkout, or where a module of JAX or of the JAX package was
loaded by the time the window closed.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Python's bytecode, for every module this run imports, cached at a fixed path
# in the checkout: where the environment turns the writing of bytecode off,
# each run would otherwise compile torch's and the program's modules afresh
# (about 15 s of set-up on the card's machine)
sys.pycache_prefix = str(ROOT / "build" / "perfbench" / "pycache")
sys.dont_write_bytecode = False
#: build and kernel caches, at fixed paths inside the checkout
CACHES = {
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "CUDA_CACHE_PATH": "nv_compute_cache",
}


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(code: int, why: str) -> int:
    print(f"perfbench: {why}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "perfbench" / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench import guard, harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
    except harness.CellError as exc:
        return fail(2, str(exc))
    problem = guard.device_problem(cell.chips)
    if problem:
        return fail(3, problem)
    try:
        import repro_torch.core.session  # noqa: F401
    except ImportError as exc:
        return fail(4, f"the program is not in this checkout ({exc})")

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cuda", t0=T0)

    found = guard.forbidden_modules(sys.modules)
    if found:
        return fail(5, f"modules of JAX or of the JAX package were loaded: {found}")
    if result["device"]["platform"] != "gpu":
        return fail(6, "a device metric would come from another device than the GPU")
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
