"""The import check compares whole top-level names, and the harness runs
on the GPU only."""

import json
import subprocess
import sys

from perfbench import guard
from perfbench.tests import tiny


def test_forbidden_by_whole_top_level_name():
    loaded = ["repro_torch", "repro_torch.core.session", "jaxtyping", "reprox", "flaxen", "torch"]
    assert guard.forbidden_modules(loaded) == []
    bad = ["repro", "repro.core.engine", "jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]
    assert guard.forbidden_modules(loaded + bad) == sorted(bad)


def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted(sys.modules)))"],
                         cwd=tiny.ROOT, capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": f"{tiny.ROOT}:{tiny.ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_loads_no_jax():
    mods = _modules_after("import perfbench.harness, perfbench.calibrate, perfbench.plants\n"
                          "import perfbench.entries.gcn_train, perfbench.entries.gcn_query_waves\n"
                          "import repro_torch.core.session, repro_torch.relational")
    assert guard.forbidden_modules(mods) == []
    assert "repro_torch" in {guard.top_level(m) for m in mods}


def test_the_reference_imports_nothing_of_the_program():
    mods = _modules_after("import perfbench.reference.gcn, perfbench.compare, perfbench.graphs")
    tops = {guard.top_level(m) for m in mods}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_no_card_no_result():
    """Here there is no GPU: the run exits with another code than 0 and
    prints no result."""
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gcn-arxiv.fullbatch",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tiny.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "perfbench:" in out.stderr
