"""A run of each cell on the CPU at a tiny size, sound and with faults
planted in the timed path: ``correct`` has to come out true, then false."""

import json

import pytest
import torch

from perfbench import calibrate, harness, plants
from perfbench.tests import tiny

E2E = {"step_ms", "peak_mem_gib", "setup_s"}


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", tiny.CELLS)
def test_sound_run_is_correct(name):
    r = harness.run_cell(tiny.cell(name), tiny.SEED, 0.3, False, device="cpu")
    assert r["correct"], r["compared"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == E2E
    assert list(r)[-1] == "compared"
    for c in r["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_traced_run_reads_its_metrics(name):
    cell = tiny.cell(name)
    r = harness.run_cell(cell, tiny.SEED + 1, 0.2, True, device="cpu")
    assert r["correct"], r["compared"]
    names = {m["name"] for m in cell.per_layer}
    # on the CPU no device event exists: only the host's and the counters'
    # metrics are read, and none of the device's is made up
    assert set(r["metrics"]) <= names
    assert "host_ms" in r["metrics"] and r["metrics"]["host_ms"]["value"] > 0
    assert not {"kernel_roofline", "device_idle_share", "copy_exposed_ms"} & set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    if name == "gcn-products.waves8":
        c = cell.config
        want = (c["edges"] + c["nodes"]) * 12 / 2 ** 30
        assert r["metrics"]["h2d_gib"]["value"] == pytest.approx(want)


@pytest.mark.parametrize("name,plant", [
    ("gcn-arxiv.fullbatch", plants.state_unchanged),
    ("gcn-arxiv.fullbatch", plants.half_batch),
    ("gcn-products.waves8", plants.dropped_waves),
    ("gcn-products.waves8", plants.altered_answer),
])
def test_planted_fault_is_not_correct(name, plant):
    with plant():
        r = harness.run_cell(tiny.cell(name), tiny.SEED, 0.2, False, device="cpu")
    assert not r["correct"], r["compared"]


@pytest.mark.parametrize("name", tiny.CELLS)
def test_controls_and_faults_read_above_a_limit(name):
    """``calibrate.py``'s readings on a sound run: the program's are within
    every limit; each control (the reference in TF32, the precision below
    the configuration's f32, in the program's place) and each fault the
    entry plants in the timed path reads above one of them."""
    cell = tiny.cell(name)
    recs = calibrate.readings(cell, tiny.SEED, 0.1, True, device="cpu")
    kinds = [r["what"] for r in recs]
    entry = harness.entry_class(cell.traffic["entry"])
    assert kinds == ["program"] + [f"control {p}" for p in entry.CONTROLS] + [
        f"fault {f}" for f in entry.FAULTS]
    for r in recs:
        nums = {k: v for k, v in r.items() if k not in ("seed", "what")}
        assert set(nums) <= set(cell.limits), nums
        if r["what"] == "control tf32-tc":
            continue  # TF32 on the tensor cores: on the CPU it is f32
        over = [k for k, v in nums.items() if v > cell.limits[k]]
        assert (not over) == (r["what"] == "program"), r


def test_a_step_that_raises_fails_the_run(monkeypatch):
    cell = tiny.cell("gcn-products.waves8")
    from perfbench.entries import gcn_query_waves

    calls = {"n": 0}
    step = gcn_query_waves.Entry.step

    def flaky(self):
        calls["n"] += 1
        if calls["n"] > cell.traffic["warm_steps"] + 1:
            raise RuntimeError("planted")
        step(self)

    monkeypatch.setattr(gcn_query_waves.Entry, "step", flaky)
    r = harness.run_cell(cell, tiny.SEED, 5.0, False, device="cpu")
    assert not r["correct"] and r["failed"] == 1
    assert r["compared"]["error"]["value"] == harness.NOT_FINITE and "planted" in r["error"]
    json.dumps(r, allow_nan=False)


@pytest.mark.cuda
def test_a_cell_on_the_card(tmp_path):
    """The harness's own command on the card, at the cell's size, a short
    window: a correct result as its last line."""
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, str(tiny.ROOT / "perfbench" / "run.py"), "--workload", "gcn-arxiv.fullbatch",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
