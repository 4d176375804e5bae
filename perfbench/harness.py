"""The benchmark's harness: it finds a cell's files by name, runs the cell
once, and builds its result line.

Everything that belongs to one cell lives in files of its own, found by
the names in ``BENCHMARK.json``:

- ``perfbench/configs/<config>.json``: the configuration's sizes;
- ``perfbench/traffic/<traffic>.json``: the traffic's parameters, among
  them ``entry``, the kind of step that drives the program;
- ``perfbench/entries/<entry>.py``: that kind's ``Entry`` (below);
- ``perfbench/limits/<cell>.json``: the limit of each number compared;
- ``perfbench/metrics/<metric>.py``: one reader a per-layer metric, which
  takes its number from the traced run's ``timeline.Trace``.

An ``Entry(config, traffic, seed, device)`` makes the inputs from the
seed, builds the program's step and warms it (set-up), and has:

- ``step()``, one step of the program, which the window calls;
- ``counters()``, the program's counters; ``least()``, the step's least
  times (``perfbench/counts``);
- ``after_window()``, whatever the entry checks of the state the window
  left; ``nonfinite()``, the window's steps whose answer is not finite;
  ``release()``, which frees the program's state;
- ``observed()``, the program's answers; ``reference(precision)``, the
  plain reference's; ``control(precision)``, the reference in a lower
  precision, shaped as ``observed()``; ``gaps(observed, reference)``, the
  numbers compared; ``compare()``, those of this run against the f64
  reference, with any guarantee of the configuration;
- ``CONTROLS``, the precisions of its controls, and ``FAULTS``, its
  planted faults by name, each of which ``replay(fault)`` runs in the timed
  path from the state the window left (before ``release``), giving answers
  shaped as ``observed()``: ``calibrate.py`` reads them.

A run: set-up (the entry's constructor), a closed-loop window of steps
for ``seconds`` (one client, the steps back to back, one synchronise at
the end), with ``trace`` a further ``trace_steps`` steps recorded for the
readers and ``breakdown_steps`` recorded with every host operator for
``breakdown``'s idle gaps, then ``after_window`` and the comparison, once
the program's state is freed.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
NOT_FINITE = 1e308


class CellError(LookupError):
    """A cell, or one of its files, is not there."""


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, object]
    traffic: Dict[str, object]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, object]]
    per_layer: List[Dict[str, object]]
    root: Path


def _json(path: Path) -> Dict[str, object]:
    if not path.is_file():
        raise CellError(f"{path} is not there")
    return json.loads(path.read_text())


def _reported(metric: Dict[str, object], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json (it has {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    base = root / "perfbench"
    traffic = _json(base / "traffic" / f"{w['traffic']}.json")
    limits = _json(base / "limits" / f"{name}.json")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        limits={k: float(v) for k, v in limits.items()},
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
        root=root,
    )


def entry_class(kind: str):
    return importlib.import_module(f"perfbench.entries.{kind}").Entry


def metric_reader(root: Path, name: str) -> Callable:
    """``read`` of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise CellError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the device --------------------------------------------------------------


def _cuda(device) -> bool:
    return str(device).startswith("cuda")


def sync(device) -> None:
    import torch

    if _cuda(device):
        torch.cuda.synchronize()


def peak_bytes(device, reset: bool = False) -> int:
    import torch

    if not _cuda(device):
        return 0
    peak = int(torch.cuda.max_memory_allocated())
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return peak


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi`` (None where it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


# -- a run -------------------------------------------------------------------


def window(entry, seconds: float, device):
    """Steps back to back until ``seconds`` have passed on the host clock,
    then one synchronise: (attempted, failed, seconds a step, error, the
    host clock's time between successive steps' returns, which is a
    step's time only where the step waits for the device itself)."""
    sync(device)
    t0 = time.perf_counter()
    n, error, marks = 0, None, [t0]
    while True:
        n += 1
        try:
            entry.step()
        except Exception as exc:  # a step that raises has failed; the run goes on to report it
            error = f"{type(exc).__name__}: {exc}"
            break
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    done = n - (error is not None)
    gaps = [b - a for a, b in zip(marks, marks[1:])]
    return n, int(error is not None), elapsed / max(done, 1), error, gaps


def traced(entry, steps: int, device, ops: bool):
    """``steps`` more steps under the profiler (``timeline.profiled``, with
    every host operator where ``ops``): their ``Trace``."""
    from torch.profiler import record_function

    from perfbench import timeline

    before = entry.counters()
    sync(device)
    with timeline.profiled(_cuda(device), ops) as events:
        with record_function(timeline.WINDOW_SPAN):
            for _ in range(steps):
                with record_function(timeline.STEP_SPAN):
                    entry.step()
            sync(device)
    after = entry.counters()
    return timeline.from_events(events, steps, before, after, entry.least())


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             t0: Optional[float] = None) -> Dict[str, object]:
    """Run ``cell`` once; its result: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device`` (and, traced, ``breakdown``); ``setup_stages``,
    the seconds of set-up before the entry and in each of its stages;
    ``window_host_ms``, the quartiles of ``window``'s host-clock times
    between steps; traced, ``traced_step_ms``, the host-clock time a step
    in the untraced window, in the readers' traced steps and in
    ``breakdown``'s (the profiler's cost is the difference); and
    ``compared``, last."""
    import torch

    from perfbench import timeline

    t0 = time.perf_counter() if t0 is None else t0
    Entry = entry_class(cell.traffic["entry"])
    t_entry = time.perf_counter()
    entry = Entry(cell.config, cell.traffic, seed, device)
    sync(device)
    setup_s = time.perf_counter() - t0
    stages = {"process_s": t_entry - t0, **getattr(entry, "stages", {})}
    peak = peak_bytes(device, reset=True)
    attempted, failed, step_s, error, gaps = window(entry, seconds, device)
    window_peak = peak_bytes(device)
    trace_rec = named = None
    if trace and error is None:
        trace_rec = traced(entry, int(cell.traffic["trace_steps"]), device, ops=False)
        named = traced(entry, int(cell.traffic["breakdown_steps"]), device, ops=True)
        attempted += trace_rec.steps + named.steps
    peak = max(peak, window_peak, peak_bytes(device))
    try:
        if error is None:
            entry.after_window()
        failed += entry.nonfinite()
        entry.release()
        compared = entry.compare()
    except Exception as exc:  # a step left nothing to compare: the run is not correct
        error = error or f"{type(exc).__name__}: {exc}"
        compared = {}
    if error is not None:
        compared["error"] = math.inf

    metrics: Dict[str, Dict[str, object]] = {}
    measured = {"step_ms": step_s * 1e3, "peak_mem_gib": window_peak / 2 ** 30, "setup_s": setup_s}
    device_rec: Dict[str, object] = {
        "platform": "gpu" if _cuda(device) else str(device),
        "kind": torch.cuda.get_device_name(0) if _cuda(device) else str(device),
        "count": cell.chips,
        "memory_peak_bytes": peak,
    }
    result: Dict[str, object] = {}
    if trace_rec is None:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = metric_reader(cell.root, m["name"])(trace_rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_rec["busy_s"] = timeline.total(trace_rec.device_busy()) / 1e9
        device_rec["window_s"] = trace_rec.window_s
        result["breakdown"] = timeline.breakdown(trace_rec, named)
        result["traced_step_ms"] = {"window": step_s * 1e3,
                                    "readers": trace_rec.window_s / trace_rec.steps * 1e3,
                                    "breakdown": named.window_s / named.steps * 1e3}
    if _cuda(device):
        device_rec["power_limit_w"] = power_limit_w()
    checks = {}
    for name, value in compared.items():
        limit = cell.limits.get(name, 0.0 if name == "error" else None)
        # JSON has no infinity: a reading that is not a finite number prints as the largest
        checks[name] = {"value": value if math.isfinite(value) else NOT_FINITE, "limit": limit}
    correct = failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"] and math.isfinite(compared[n])
        for n, c in checks.items())
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_rec}
    out.update(result)
    out["setup_stages"] = stages
    if gaps:
        q = statistics.quantiles(gaps, n=4) if len(gaps) > 1 else [gaps[0]] * 3
        out["window_host_ms"] = {"min": min(gaps) * 1e3, "q1": q[0] * 1e3, "median": q[1] * 1e3,
                                 "q3": q[2] * 1e3, "max": max(gaps) * 1e3}
    if error is not None:
        out["error"] = error
    out["compared"] = checks
    return out
