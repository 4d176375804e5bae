"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup of a cell's files by name."""

import json
import re
import shutil

import pytest

from perfbench import harness
from perfbench.tests import tiny

BENCH = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TEXT = re.compile(r"[^\t\n]{1,200}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.fullmatch(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.fullmatch(w) for w in BENCH["command"])
    assert not any(w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((tiny.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in metrics()] + [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]] + [k for c in BENCH["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.fullmatch(n), n
    for m in metrics():
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]] + [c["source"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert TEXT.fullmatch(text), text
    for group in (BENCH["configs"], BENCH["workloads"], metrics()):
        assert len({x["name"] for x in group}) == len(group)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (tiny.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == LAYER_KEYS
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_reports_what_the_contract_asks():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in metrics():
        assert set(m.get("workloads", cells)) <= cells
    for name in cells:
        cell = harness.load_cell(tiny.ROOT, name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("name", tiny.CELLS)
def test_each_cells_files_are_found_by_name(name):
    cell = harness.load_cell(tiny.ROOT, name)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert harness.entry_class(cell.traffic["entry"]).__name__ == "Entry"
    assert cell.limits
    for m in cell.per_layer:
        assert callable(harness.metric_reader(tiny.ROOT, m["name"]))
    with pytest.raises(harness.CellError):
        harness.load_cell(tiny.ROOT, name + "-absent")


def test_a_new_cell_and_metric_given_as_files_alone_load(tmp_path):
    """A later change adds a cell (a traffic file, a limits file) and a
    metric (its reader) and entries in BENCHMARK.json, and edits no file."""
    shutil.copytree(tiny.ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((tmp_path / "perfbench/traffic/query_step.edge_node.json").read_text())
    traffic["wrt"] = ["Node"]
    (tmp_path / "perfbench/traffic/query_step.node.json").write_text(json.dumps(traffic))
    (tmp_path / "perfbench/limits/gcn-products.waves8-node.json").write_text(
        (tmp_path / "perfbench/limits/gcn-products.waves8.json").read_text())
    (tmp_path / "perfbench/metrics/wave_count.py").write_text(
        "def read(t):\n    return t.steps\n")
    bench["workloads"].append({"name": "gcn-products.waves8-node", "config": "gcn-ogbn-products",
                               "traffic": "query_step.node", "chips": 1, "why": "w.r.t. Node alone"})
    bench["per_layer"].append({"name": "wave_count", "unit": "waves", "better": "lower",
                               "source": "program_counter", "layer": "out-of-core waves",
                               "moves": "step_ms", "workloads": ["gcn-products.waves8-node"]})
    host = next(m for m in bench["per_layer"] if m["name"] == "host_ms")
    host["workloads"].append("gcn-products.waves8-node")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tmp_path, "gcn-products.waves8-node")
    assert cell.traffic["wrt"] == ["Node"]
    assert [m["name"] for m in cell.per_layer] == ["host_ms", "wave_count"]
    assert harness.metric_reader(tmp_path, "wave_count")(type("T", (), {"steps": 8})) == 8
    assert harness.load_cell(tmp_path, "gcn-products.waves8").traffic["wrt"] == ["Edge", "Node"]
