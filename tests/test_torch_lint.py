"""The port's engine-invariant linter (``repro_torch.analysis.lint``),
mirroring ``tests/test_lint.py``: the port lints clean, and each rule
actually fires on a seeded violation in a synthetic ``src/repro_torch``
tree — a linter that never fails is indistinguishable from one that
checks nothing. The reference's rules read for the port: the four tiers
``cuda``/``sanitizer``/``ref``/``torch``, a ``torch.autograd.Function``
for ``jax.custom_vjp``, no ``torch`` import in plan-time code, and no
``torch.compile``/``torch.jit`` anywhere (the port's steps are eager)."""

import subprocess
import sys
from pathlib import Path

from repro_torch.analysis import lint

REPO = Path(__file__).resolve().parent.parent


def test_repo_lints_clean():
    violations = lint.run(REPO)
    assert violations == [], "\n".join(v.render() for v in violations)


def test_cli_exit_codes(tmp_path, capsys):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint"],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ok" in proc.stdout
    # an empty tree has no files to lint — and no violations (the CLI's
    # main, in this process: one interpreter start is enough)
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    assert lint.main(["--root", str(tmp_path)]) == 0
    # a violation exits non-zero
    _tree(tmp_path, "core/planner.py", "import torch\n")
    capsys.readouterr()
    assert lint.main(["--root", str(tmp_path)]) == 1
    assert "[planner-pure]" in capsys.readouterr().out


def _tree(tmp_path, rel, text):
    path = tmp_path / "src" / "repro_torch" / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return tmp_path


def _rules(violations):
    return {v.rule for v in violations}


def test_seeded_compile_or_jit_detected(tmp_path):
    for i, text in enumerate((
        "import torch\n\ndef f(m):\n    return torch.compile(m)\n",
        "import torch\n\n@torch.jit.script\ndef f(x):\n    return x\n",
        "from torch import compile\n",
        "import torch.jit\n",
    )):
        root = _tree(tmp_path / str(i), "models/model.py", text)
        assert "jit-scope" in _rules(lint.run(root)), text
    root2 = _tree(tmp_path / "ok", "models/model.py", "import torch\n\ndef f(x):\n    return torch.relu(x)\n")
    assert "jit-scope" not in _rules(lint.run(root2))


def test_seeded_torch_in_planner_detected(tmp_path):
    root = _tree(tmp_path, "core/planner.py", "import torch\n\ndef cost(x):\n    return torch.sum(x)\n")
    assert "planner-pure" in _rules(lint.run(root))
    root1 = _tree(tmp_path / "a", "core/rewrite.py", "from torch import nn\n")
    assert "planner-pure" in _rules(lint.run(root1))
    root2 = _tree(tmp_path / "ok", "core/rewrite.py", "from dataclasses import dataclass\n")
    assert "planner-pure" not in _rules(lint.run(root2))


def test_seeded_unhashable_cache_key_detected(tmp_path):
    root = _tree(
        tmp_path,
        "core/engine.py",
        "def _rel_signature(name, rel):\n"
        "    return {name: rel.key_arity}\n"
        "def env_signature(env, seed=None):\n"
        "    return tuple(sorted(env))\n"
        "def _stats_key(stats):\n"
        "    return None\n",
    )
    vs = lint.run(root)
    assert any(v.rule == "cache-key" and "_rel_signature" in v.message for v in vs)


def test_seeded_missing_tier_detected(tmp_path):
    root = _tree(
        tmp_path,
        "core/kernels.py",
        'DISPATCH_OPS = ("segment_sum",)\n'
        "def register_impl(op, tier, fn, **kw):\n"
        "    pass\n"
        'register_impl("segment_sum", "torch", None)\n',
    )
    vs = lint.run(root)
    assert any(v.rule == "dispatch-pairing" and "cuda/sanitizer/ref" in v.message for v in vs)


def test_seeded_missing_contract_detected(tmp_path):
    # an ops.py without CONTRACT = KernelContract(...) fires the rule
    forward = (
        "import torch\n\n"
        "class _F(torch.autograd.Function):\n"
        "    @staticmethod\n    def forward(ctx, x):\n        return x\n"
        "    @staticmethod\n    def backward(ctx, g):\n        return g\n"
    )
    root = _tree(tmp_path, "kernels/badkern/ops.py", forward)
    (tmp_path / "src" / "repro_torch" / "kernels" / "badkern" / "ref.py").write_text(
        "def forward(x):\n    return x\n")
    vs = [v for v in lint.run(root) if v.rule == "kernel-contract"]
    assert any("CONTRACT" in v.message for v in vs)
    assert "dispatch-pairing" not in _rules(lint.run(root))
    # declaring one silences it
    root2 = _tree(
        tmp_path / "ok", "kernels/goodkern/ops.py",
        forward + "from repro_torch.core.kernels import KernelContract\n"
        'CONTRACT = KernelContract(op="goodkern", dtypes="floating")\n',
    )
    ok_dir = tmp_path / "ok" / "src" / "repro_torch" / "kernels" / "goodkern"
    (ok_dir / "ref.py").write_text("def forward(x):\n    return x\n")
    assert "kernel-contract" not in _rules(lint.run(root2))


def test_seeded_contract_module_gap_detected(tmp_path):
    # a DISPATCH_OPS op absent from _CONTRACT_MODULES fires the rule
    root = _tree(
        tmp_path,
        "core/kernels.py",
        'DISPATCH_OPS = ("segment_sum", "blocked_matmul")\n'
        '_CONTRACT_MODULES = {"segment_sum": "repro_torch.kernels.segsum.ops"}\n',
    )
    vs = [v for v in lint.run(root) if v.rule == "kernel-contract"]
    assert any("blocked_matmul" in v.message for v in vs)


def test_seeded_unpaired_kernel_forward_detected(tmp_path):
    root = _tree(tmp_path, "kernels/badkern/ops.py", "def forward(x):\n    return x\n")
    vs = [v for v in lint.run(root) if v.rule == "dispatch-pairing"]
    msgs = " ".join(v.message for v in vs)
    assert "autograd.Function" in msgs and "ref.py" in msgs
    # a Function without a backward does not pair either
    root2 = _tree(tmp_path / "b", "kernels/badkern/ops.py",
                  "import torch\n\nclass _F(torch.autograd.Function):\n"
                  "    @staticmethod\n    def forward(ctx, x):\n        return x\n")
    assert any("autograd.Function" in v.message for v in lint.run(root2) if v.rule == "dispatch-pairing")


def test_seeded_fire_and_forget_task_detected(tmp_path):
    root = _tree(
        tmp_path,
        "serving/service.py",
        "import asyncio\n\n"
        "async def go(loop, coro):\n"
        "    loop.create_task(coro)\n",
    )
    vs = [v for v in lint.run(root) if v.rule == "task-retention"]
    msgs = " ".join(v.message for v in vs)
    assert "fire-and-forget" in msgs and "name=" in msgs
    # retained + named passes
    root2 = _tree(
        tmp_path / "ok",
        "serving/service.py",
        "import asyncio\n\n"
        "async def go(loop, coro):\n"
        '    t = loop.create_task(coro, name="x")\n'
        "    return t\n",
    )
    assert "task-retention" not in _rules(lint.run(root2))
