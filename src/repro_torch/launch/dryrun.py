"""Multi-pod dry run: walk every (architecture × input shape × mesh)
step on the ``meta`` device, in one process, as rank 0 of the production
mesh (16 × 16, and 2 × 16 × 16 with ``--multi-pod``) runs it — the
counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles the step for 512 placeholder host devices. Nothing is allocated
on a device and nothing is launched: the model is built at full depth on
``meta`` with rank 0's shards (``build_model(cfg, device="meta",
mesh=<axis sizes>)``), the step runs through the port's own entry points
(``make_train_step``, ``make_prefill_step``, ``make_decode_step``) on the
``torch`` tier, and the mesh's collectives are rank 0's shape-only ones
(``collectives.ShapeComm``), which record what they would move. So
sharding mismatches and unplaced layers surface here as they would on
the ranks.

Per combination it records rank 0's argument and output bytes
(parameters, Adam's state, the batch's rows or the caches), the step's
FLOPs (``torch.utils.flop_counter.FlopCounterMode`` over a second walk:
the first lowers each relational product once, and the second runs each
at its site's shape, 2·m·k·n), the bytes its operations read and write
(each non-view operation's operands and results: no fusion), its
collectives by op and group, and ``launch/roofline.py``'s terms, in
``<out>/<arch>_<shape>_pod{1,2}.json``. XLA's ``memory_analysis`` temp
size has no counterpart and is not estimated (ROADMAP.md §3). An error is
recorded and the run goes on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-405b \\
      --shape train_4k [--multi-pod] [--out build/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --reduced   # reduced()
      configs and shapes on a 2 × 2 (2 × 2 × 2) mesh: seconds
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Mapping, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, InputShape, get_config

from .roofline import roofline

# (arch, shape) pairs skipped, with the reference's rationale.
SKIPS = {
    ("gemma2-9b", "long_500k"): "global layers are full attention (4k ctx)",
    ("deepseek-coder-33b", "long_500k"): "pure full attention",
    ("deepseek-v3-671b", "long_500k"): "full attention (MLA) — no windowed variant",
    ("llama3-405b", "long_500k"): "pure full attention",
    ("qwen2-vl-72b", "long_500k"): "pure full attention",
    ("olmoe-1b-7b", "long_500k"): "pure full attention",
    ("whisper-small", "long_500k"): "decoder is spec'd to ≤448 positions",
}

#: the production meshes' axis sizes (``launch.mesh.make_production_mesh``)
PRODUCTION = {"data": 16, "model": 16}
PRODUCTION_POD = {"pod": 2, "data": 16, "model": 16}
#: the meshes of a ``--reduced`` run
REDUCED = {"data": 2, "model": 2}
REDUCED_POD = {"pod": 2, "data": 2, "model": 2}
#: a ``--reduced`` run's longest sequence and largest batch
REDUCED_SEQ, REDUCED_BATCH = 16, 4


def mesh_sizes(multi_pod: bool, reduced: bool = False) -> Dict[str, int]:
    """The axis sizes a combination runs on."""
    if reduced:
        return dict(REDUCED_POD if multi_pod else REDUCED)
    return dict(PRODUCTION_POD if multi_pod else PRODUCTION)


def input_shape(shape_name: str, reduced: bool = False) -> InputShape:
    """``INPUT_SHAPES[shape_name]``, cut to ``REDUCED_SEQ`` tokens and
    ``REDUCED_BATCH`` rows for a ``--reduced`` run."""
    shp = INPUT_SHAPES[shape_name]
    if not reduced:
        return shp
    return dataclasses.replace(shp, seq_len=min(shp.seq_len, REDUCED_SEQ),
                               global_batch=min(shp.global_batch, REDUCED_BATCH))


def _nbytes(node) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(node) if isinstance(t, torch.Tensor))


class ByteCounter(TorchDispatchMode):
    """The bytes every operation but a view reads and writes: its tensor
    operands and results, summed (no fusion: what an eager step moves at
    most)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.bytes += _nbytes((args, kwargs, out))
        return out


def _rows(t: torch.Tensor, fold: int) -> int:
    """The bytes of the rank's rows of a batch tensor over a fold of
    ``fold`` data ranks (all of them where the rows do not split)."""
    n = t.numel() * t.element_size()
    return n // fold if t.dim() and t.shape[0] % fold == 0 else n


def walk(cfg, sizes: Mapping[str, int], kind: str, batch: int, seq: int, *,
         length: Optional[int] = None) -> Dict[str, Any]:
    """Rank 0's step of ``kind`` ("train", "prefill", "decode") of the
    model of ``cfg`` on a mesh of axis ``sizes``, walked on ``meta`` over a
    whole batch of ``batch`` rows of ``seq`` tokens (decode: one token
    against caches of ``seq`` positions, ``length`` of them valid, default
    ``seq - 1``): its argument and output bytes, FLOPs, bytes read and
    written and collectives (module docstring)."""
    import repro_torch
    from repro_torch.models import build_model
    from repro_torch.serving import init_cache, make_decode_step, make_prefill_step
    from repro_torch.train import init_train_state, make_train_step

    meta = torch.device("meta")
    sizes = dict(sizes)
    model = build_model(cfg, device=meta, mesh=sizes)
    place = model.placement
    db = repro_torch.Database(device=meta, dispatch="torch")
    dt = getattr(torch, cfg.dtype)
    fold = place.size(place.batch)
    params = {k: p.detach() for k, p in model.named_parameters()}
    args: Dict[str, int] = {"params": _nbytes(params)}

    def extras(b):
        out = {}
        if cfg.encoder_layers:
            out["frames"] = torch.zeros((b, cfg.enc_seq, cfg.d_model), dtype=dt, device=meta)
        if cfg.vis_seq:
            out["patches"] = torch.zeros((b, cfg.vis_seq, cfg.d_model), dtype=dt, device=meta)
        return out

    if kind == "train":
        state = init_train_state(model)
        args["opt_state"] = _nbytes((state.opt_state["mu"], state.opt_state["nu"]))
        tokens = torch.zeros((batch, seq), dtype=torch.int32, device=meta)
        inputs = {"tokens": tokens, "labels": tokens, **extras(batch)}
        step = make_train_step(model, mesh=sizes, database=db)

        def run():
            return step(state.params, state.opt_state, inputs)
    elif kind == "prefill":
        inputs = {"tokens": torch.zeros((batch, seq), dtype=torch.int32, device=meta), **extras(batch)}
        step = make_prefill_step(model, seq + (cfg.vis_seq or 0), mesh=sizes, db=db)

        def run():
            return step(inputs)
    elif kind == "decode":
        caches = init_cache(cfg, batch, seq, meta, place=place)
        args["caches"] = _nbytes(caches)
        inputs = {"token": torch.zeros((batch, 1), dtype=torch.int32, device=meta)}
        if cfg.encoder_layers:
            inputs["enc_out"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model), dtype=dt, device=meta)
        step = make_decode_step(model, mesh=sizes, db=db)
        at = seq - 1 if length is None else length

        def run():
            return step(inputs["token"], caches, at, enc_out=inputs.get("enc_out"))
    else:
        raise ValueError(f"unknown step kind {kind!r}")
    args["batch"] = sum(_rows(t, fold) for t in inputs.values())

    run()  # the engine lowers each relational product at its first call
    place.comm.record.clear()
    with FlopCounterMode(display=False) as flops, ByteCounter() as moved:
        out = run()
    args["total"] = sum(args.values())
    return {"argument_bytes": args, "output_bytes": _nbytes(out), "param_bytes": args["params"],
            "flops": float(flops.get_total_flops()), "bytes_accessed": float(moved.bytes),
            "collectives": place.comm.collectives(), "mesh": sizes, "batch_fold": fold}


def dryrun_one(arch: str, shape_name: str, *, multi_pod: bool = False, verbose: bool = True,
               overrides: Optional[Dict[str, Any]] = None, reduced: bool = False) -> Dict[str, Any]:
    """One combination's record (module docstring); ``reduced`` walks
    ``get_config(arch).reduced()`` at ``input_shape(..., reduced=True)``
    on the reduced meshes."""
    if (arch, shape_name) in SKIPS:
        return {
            "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
            "status": "skipped", "reason": SKIPS[(arch, shape_name)],
        }
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shp = input_shape(shape_name, reduced)
    sizes = mesh_sizes(multi_pod, reduced)
    t0 = time.time()
    got = walk(cfg, sizes, shp.kind, shp.global_batch, shp.seq_len)
    roof = roofline(got["flops"], got["bytes_accessed"], got["collectives"], sizes, arch=arch,
                    shape=shape_name, cfg=cfg, input_shape=shp)
    rec = {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "reduced": reduced,
        "overrides": overrides or {},
        "status": "ok",
        "walk_s": round(time.time() - t0, 1),
        **got,
        "roofline": roof,
    }
    if verbose:
        print(json.dumps(rec, indent=2, default=str))
    return rec


def summary(out: str) -> str:
    """A markdown table of the records in ``out``: a row per (arch, pods),
    a column per input shape, each cell rank 0's argument GB, the compute,
    memory and collective terms in ms and the dominant one — or "skipped"."""
    shapes = tuple(INPUT_SHAPES)
    rows = ["| arch | pods | " + " | ".join(shapes) + " |", "|---|---|" + "---|" * len(shapes)]
    for arch in ARCH_IDS:
        for pod in (1, 2):
            cells = []
            for shape in shapes:
                with open(os.path.join(out, f"{arch}_{shape}_pod{pod}.json")) as f:
                    r = json.load(f)
                if r["status"] != "ok":
                    cells.append(r["status"])
                    continue
                t = r["roofline"]
                cells.append(f"{r['argument_bytes']['total'] / 1e9:.2f} GB · {t['compute_s'] * 1e3:.1f} / "
                             f"{t['memory_s'] * 1e3:.1f} / {t['collective_s'] * 1e3:.1f} ms · "
                             f"{t['dominant'][:-2]}")
            rows.append(f"| {arch} | {pod} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def _parse_set(pairs) -> Dict[str, Any]:
    overrides: Dict[str, Any] = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        try:
            overrides[k] = int(v)
        except ValueError:
            try:
                overrides[k] = float(v)
            except ValueError:
                overrides[k] = v
    return overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced() configs and shapes on a 2 x 2 (2 x 2 x 2) mesh")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="config override (repeatable), e.g. --set ssm_chunk=512",
    )
    ap.add_argument("--tag", default="", help="suffix for the output file")
    ap.add_argument("--summary", action="store_true",
                    help="print a markdown table of the records in --out and walk nothing")
    args = ap.parse_args(argv)
    if args.summary:
        print(summary(args.out))
        return
    overrides = _parse_set(args.set)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        combos = [(a, s, mp) for a in ARCH_IDS for s in INPUT_SHAPES for mp in (False, True)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        combos = [(args.arch, args.shape, args.multi_pod)]

    for a, s, mp in combos:
        tag = f"{a}_{s}_{'pod2' if mp else 'pod1'}"
        if args.tag:
            tag += f"_{args.tag}"
        try:
            rec = dryrun_one(a, s, multi_pod=mp, verbose=not args.all, overrides=overrides or None,
                             reduced=args.reduced)
        except Exception as e:  # noqa: BLE001 — record and continue
            rec = {
                "arch": a, "shape": s, "multi_pod": mp,
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc(),
            }
            print(f"[FAIL] {tag}: {e}")
        if args.all:
            print(f"{tag}: {rec['status']}" + (f" in {rec['walk_s']} s" if "walk_s" in rec else ""),
                  flush=True)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=2, default=str)


if __name__ == "__main__":
    main()
