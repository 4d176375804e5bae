"""The operations and bytes of the GCN cells' steps, from their shapes.

Each relational operation counts the work its inputs need, every input
byte read once and every output byte written once, whatever a kernel
reads again (f32 values: 4 bytes; an edge key <src, dst>: two int32):

- an aggregation ``out[dst] = sum of w * h[src]`` is one join-aggregate:
  the edges (keys and weights), the node rows and the output rows, each
  once; a multiply and an add an edge and feature;
- the per-edge gradient ``dEdge[e] = <h[src_e], g[dst_e]>``: the edge keys,
  both node tables and one output value an edge; 2 * D operations an edge;
- a product (M, K) x (K, N): both operands and the output; 2 * M * K * N;
- an elementwise operation: its inputs and outputs, once each.

The counts depend on the shapes alone, so they are the same whatever
implements the step. ``least_seconds`` turns them into the least time of
a step on a chip of the given peaks.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

F32 = 4
KEY = 8  # <src, dst> as two int32
IDX = 8  # an int64 label

Op = Tuple[str, float, float]  # (name, operations, bytes)


def peaks() -> Dict[str, float]:
    """The published peaks of ``h100.json``."""
    raw = json.loads((Path(__file__).with_name("h100.json")).read_text())
    return {k: v for k, v in raw.items() if isinstance(v, (int, float))}


def aggregate(what: str, e: int, n_in: int, n_out: int, d: int) -> Op:
    return (what, 2.0 * e * d, e * (KEY + F32) + (n_in + n_out) * d * F32)


def edge_grad(what: str, e: int, n: int, d: int) -> Op:
    return (what, 2.0 * e * d, e * KEY + 2 * n * d * F32 + e * F32)


def product(what: str, m: int, k: int, n: int) -> Op:
    return (what, 2.0 * m * k * n, (m * k + k * n + m * n) * F32)


def elementwise(what: str, elems: int, reads: int, writes: int, ops: int = 1, extra: int = 0) -> Op:
    return (what, float(ops * elems), elems * (reads + writes) * F32 + extra)


def train_step(nodes: int, edges: int, feat: int, hidden: int, classes: int) -> List[Op]:
    """The full-batch step of the two-layer GCN with Adam (``edges``
    counts the self loops)."""
    n, e, f, h, c = nodes, edges, feat, hidden, classes
    params = f * h + h * c
    return [
        aggregate("conv1 A x", e, n, n, f),
        product("z1 = h0 W1", n, f, h),
        elementwise("relu", n * h, 1, 1),
        aggregate("conv2 A a1", e, n, n, h),
        product("z2 = h1 W2", n, h, c),
        elementwise("loss: log_softmax, pick, mean", n * c, 1, 0, ops=4, extra=n * IDX),
        elementwise("dz2 = (softmax - onehot) / n", n * c, 1, 1, ops=3, extra=n * IDX),
        product("dW2 = h1^T dz2", h, n, c),
        product("dh1 = dz2 W2^T", n, c, h),
        aggregate("da1 = A^T dh1", e, n, n, h),
        elementwise("dz1 = da1 * (z1 > 0)", n * h, 2, 1),
        product("dW1 = h0^T dz1", f, n, h),
        elementwise("adam", params, 4, 3, ops=12),
    ]


def query_step(nodes: int, edges: int, width: int, wrt: Sequence[str]) -> List[Op]:
    """The GCN layer's gradient query (loss = sum of conv^2 / n) with the
    gradients ``wrt`` asks for."""
    n, e, d = nodes, edges, width
    ops = [
        aggregate("conv = A Node", e, n, n, d),
        elementwise("loss: sum of conv^2 / n", n * d, 1, 0, ops=2),
        elementwise("dconv = 2 conv / n", n * d, 1, 1),
    ]
    if "Node" in wrt:
        ops.append(aggregate("dNode = A^T dconv", e, n, n, d))
    if "Edge" in wrt:
        ops.append(edge_grad("dEdge = <Node[src], dconv[dst]>", e, n, d))
    return ops


def link_bytes(edges: int, wrt: Sequence[str]) -> Tuple[float, float]:
    """Host-link bytes of a step whose Edge relation lies on the host:
    Edge in (keys and weights), dEdge out."""
    return float(edges * (KEY + F32)), float(edges * F32 if "Edge" in wrt else 0)


def totals(ops: List[Op]) -> Tuple[float, float]:
    return sum(o[1] for o in ops), sum(o[2] for o in ops)


def least_seconds(ops: List[Op], link: Tuple[float, float], pk: Dict[str, float]) -> Dict[str, float]:
    """The least device time (operations at the f32-input peak, or bytes at
    the memory rate, whichever is longer) and the least time of the step on
    the chip (that, or the host link's busier direction)."""
    flops, nbytes = totals(ops)
    device = max(flops / pk["f32_input_flops_per_s"], nbytes / pk["hbm_bytes_per_s"])
    link_s = max(link) / pk["host_link_bytes_per_s"]
    return {"flops": flops, "bytes": nbytes, "device_s": device, "link_s": link_s,
            "chip_s": max(device, link_s)}
