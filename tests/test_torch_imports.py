"""The port stands alone: no file of ``src/repro_torch/``, nor
``chip_smoke.py``, imports ``jax`` or the JAX package ``repro``. Of the
tests only ``test_torch_cuda.py`` is held to the same rule, because it runs
on the card's machine, which has no JAX, and ``torch_mesh_workers.py``,
the rank program of the mesh tests, whose ranks start without JAX; the
other tests import both."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "tests" / "test_torch_cuda.py",
    ROOT / "tests" / "torch_mesh_workers.py",
]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None))
            in ("import_module", "__import__")
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            yield node.lineno, node.args[0].value.split(".")[0]


def test_the_scan_sees_the_port():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py").exists()
    launch = ROOT / "src" / "repro_torch" / "launch"
    assert {launch / "mesh.py", launch / "collectives.py"} <= set(FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [(line, mod) for line, mod in _imported_roots(tree) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
