"""The readings that a cell's limits (``perfbench/limits/<cell>.json``) are
set from, taken on the GPU at the cell's own size, many seeds in one
process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 51] [--faults]

For each seed it runs the cell as a run does (set-up, a window of
``--seconds``, the entry's ``after_window``), then reads, against the f64
reference: the numbers of the program's sound run (the lower readings),
those of each control the entry names (``Entry.CONTROLS``: the reference in
that precision put in the program's place) and, with ``--faults``, those
of each planted fault the entry names (``Entry.FAULTS``, run through
``Entry.replay`` in the timed path from the state the window left): the
upper readings. Everything that belongs to one kind of cell is its
entry's. The benchmark's own runs do not run this. One JSON line a
reading, then a summary line: the largest sound reading and the least
reading of each control and fault, by number.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def summary(lines):
    """By number: the largest reading of the program, the least of each
    control and fault."""
    out = {}
    for rec in lines:
        kind = rec["what"]
        for k, v in rec.items():
            if k in ("seed", "what"):
                continue
            s = out.setdefault(k, {})
            s[kind] = max(s.get(kind, v), v) if kind == "program" else min(s.get(kind, v), v)
    return out


def readings(cell, seed: int, seconds: float, faults: bool, device: str = "cuda"):
    """The readings of one seed, each a dict of numbers under ``what``."""
    import torch

    from perfbench import harness

    entry = harness.entry_class(cell.traffic["entry"])(cell.config, cell.traffic, seed, device)
    if seconds > 0:
        harness.window(entry, seconds, device)
    entry.after_window()
    faulty = {name: entry.replay(plant) for name, plant in entry.FAULTS.items()} if faults else {}
    entry.release()
    ref = entry.reference("f64")
    out = [{"seed": seed, "what": "program", **entry.gaps(entry.observed(), ref)}]
    for prec in entry.CONTROLS:
        out.append({"seed": seed, "what": f"control {prec}", **entry.gaps(entry.control(prec), ref)})
    for name, obs in faulty.items():
        out.append({"seed": seed, "what": f"fault {name}", **entry.gaps(obs, ref)})
    del entry, ref, faulty
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0, help="the window before the readings")
    ap.add_argument("--faults", action="store_true", help="read the entry's planted faults too")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    lines = []
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        for rec in readings(cell, seed, args.seconds, args.faults):
            lines.append(rec)
            print(json.dumps(rec), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps({"summary": summary(lines), "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
