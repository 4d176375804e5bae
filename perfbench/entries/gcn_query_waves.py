"""Entry ``gcn_query_waves``: the GCN layer's relational gradient query
stepped through ``Database(memory_budget=...).query(q).step(wrt=...)``,
out of core: the session's budget is the Node relation's bytes and a
``budget_edge_share``-th of the Edge relation's, so Edge lies on the host
and streams through each step in chunk waves.

    conv = sum over Edge of w * Node[src], by dst
    loss = (sum of conv^2) / n

Set-up draws the graph and the node rows on the device from the seed,
lays the edges out by destination (``partitioned_edges``, the program's
layout for a budget), puts both relations, and runs ``warm_steps`` steps
(the first lowers and spills Edge to pinned host memory). Every step's
loss is kept; the window's last step's dNode and dEdge are compared with
the reference's, whose inputs are drawn again from the seed once the
program's state is freed.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import torch
from torch.profiler import record_function

from perfbench import compare, graphs, plants
from perfbench.counts import gcn as counts
from perfbench.reference import gcn as reference


def loss_query(n: int):
    """mean over nodes of sum_d conv^2, conv = sum_dst w * Node[src]."""
    from repro_torch.core import fra
    from repro_torch.core.kernels import ADD, MUL, SQUARE, SUM_CHUNK, scale_kernel
    from repro_torch.core.keys import EMPTY_KEY, TRUE, L, eq_pred, identity_key, jproj

    conv = fra.Agg(identity_key(1), ADD, fra.Join(eq_pred((0, 0)), jproj(L(1)), MUL,
                                                  fra.scan("Edge", 2), fra.scan("Node", 1)))
    sq = fra.Select(TRUE, identity_key(1), SQUARE, conv)
    loss = fra.Agg(EMPTY_KEY, ADD, fra.Select(TRUE, identity_key(1), SUM_CHUNK, sq))
    return fra.Query(fra.Select(TRUE, identity_key(0), scale_kernel(1.0 / n), loss),
                     inputs=("Edge", "Node"))


class Entry:
    CONTROLS = ("tf32",)
    #: faults planted in the timed path, by name (``replay``)
    FAULTS = {"dropped_waves": plants.dropped_waves, "altered_answer": plants.altered_answer}

    def __init__(self, config: Dict[str, object], traffic: Dict[str, object], seed: int, device):
        import repro_torch
        from repro_torch import kernels
        from repro_torch.relational import partitioned_edges

        t0 = time.perf_counter()
        self._kernels = kernels
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.wrt = tuple(traffic["wrt"])
        n, d = config["nodes"], config["width"]
        keys, w, x = self.inputs()
        self.x_digest = float(x.double().sum())
        edge = partitioned_edges(keys, w, n, 1)
        del keys, w
        node_bytes = n * d * counts.F32
        edge_bytes = edge.nnz * (counts.KEY + counts.F32)
        self.budget = node_bytes + edge_bytes / config["budget_edge_share"]
        self.db = repro_torch.Database(device=self.device, memory_budget=self.budget)
        self.db.put("Edge", edge)
        self.db.put("Node", x, keys=("node",))
        del edge, x
        self.handle = self.db.query(loss_query(n))
        self.out = self.grads = None
        self.losses = []
        self.stages = {"inputs_s": time.perf_counter() - t0}
        for i in range(int(traffic["warm_steps"])):
            t1 = time.perf_counter()
            self.step()
            self.stages[f"warm_step{i + 1}_s"] = time.perf_counter() - t1

    def inputs(self):
        """The graph and node rows of the seed (the same bits every call)."""
        c = self.config
        gen = graphs.generator(self.device, self.seed)
        return graphs.draw_graph(gen, c["nodes"], c["edges"], c["width"])

    def step(self) -> None:
        self.out = self.grads = None  # the last step's answers go before the next is made
        with record_function("port:QueryHandle.step"):
            out, grads = self.handle.step(wrt=self.wrt)
        self.losses.append(out.data.detach().reshape(()))
        self.out, self.grads = out, grads

    def after_window(self) -> None:
        """Nothing: the window's own last step is the one compared."""

    def replay(self, fault) -> Dict[str, object]:
        """One more step with ``fault`` planted: its answers; the window's
        last answers stay the ones compared."""
        keep = self.out, self.grads, self.losses
        self.losses = []
        with fault():
            self.step()
        out = self._answers()
        self.out, self.grads, self.losses = keep
        return out

    def _answers(self) -> Dict[str, object]:
        return {
            "losses": [float(v) for v in self.losses],
            "dnode": self.grads["Node"].data if "Node" in self.wrt else None,
            "dedge": self.grads["Edge"].values if "Edge" in self.wrt else None,
        }

    def counters(self) -> Dict[str, object]:
        return {"launches": self._kernels.launch_counts(), "spill": self.db.counters()["spill"]}

    def least(self) -> Dict[str, float]:
        c = self.config
        e = c["edges"] + c["nodes"]
        ops = counts.query_step(c["nodes"], e, c["width"], self.wrt)
        return counts.least_seconds(ops, counts.link_bytes(e, self.wrt), counts.peaks())

    def nonfinite(self) -> int:
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self) -> None:
        """Keep the answers and what the configuration's guarantee needs to
        be checked; free the program's state."""
        last = self.handle.last
        self.num_waves = getattr(last, "num_waves", 1)
        self.edge_device = self.db.get("Edge").keys.device.type
        self.answers = self._answers()
        self.db.release()
        del self.db, self.handle, self.out, self.grads, last
        self.losses = []
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "f64") -> Dict[str, object]:
        keys, w, x = self.inputs()
        if float(x.double().sum()) != self.x_digest:
            raise RuntimeError("the seed's node rows were not drawn again bit for bit")
        return reference.query_step(keys, w, x, reference.Precision(precision))

    def observed(self) -> Dict[str, object]:
        return self.answers

    def control(self, precision: str) -> Dict[str, object]:
        ctl = self.reference(precision)
        return {"losses": [ctl["loss"]], "dnode": ctl["dnode"], "dedge": ctl["dedge"]}

    def gaps(self, obs: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
        return compare.query_gaps(obs, ref)

    def compare(self) -> Dict[str, float]:
        gaps = self.gaps(self.observed(), self.reference())
        # the configuration's guarantee: Edge stays on the host and streams
        # in the waves its budget makes
        gaps["waves"] = float(abs(self.num_waves - self.config["budget_edge_share"]))
        on_host = self.device.type == "cpu" or self.edge_device == "cpu"
        gaps["edge_on_device"] = 0.0 if on_host else 1.0
        return {k: (v if math.isfinite(v) else math.inf) for k, v in gaps.items()}
