"""The cells at sizes a CPU test run can hold (widths and counts cut;
the code path is the chip's)."""

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import harness  # noqa: E402

SIZES = {
    "gcn-arxiv.fullbatch": dict(nodes=3000, edges=20000, features=16, hidden=32, classes=5),
    "gcn-products.waves8": dict(nodes=3000, edges=30000, width=16),
}
CELLS = tuple(SIZES)
SEED = 2 ** 31 + 12345


def cell(name: str) -> harness.Cell:
    c = harness.load_cell(ROOT, name)
    return dataclasses.replace(c, config={**c.config, **SIZES[name]})
