"""Entry ``gcn_train``: the paper's two-layer GCN trained full-batch with
Adam through the program's relational ops, as ``examples/gcn_train.py``
runs it: ``gcn_conv`` (the join-aggregate, its backward the RA-autodiff
gradient query), ``rel_linear``, autograd's backward, ``adam_update``,
under ``Database().activate()``.

Set-up draws the graph, labels and initial weights on the device from the
seed, builds the step once and runs its first ``checked_steps`` steps
through the same ``step`` the window calls: they lower and warm every
shape, and the comparison holds them to the reference from the seed
(their losses, the first gradient as Adam's first moment holds it after
step 1, and the parameters' change after the last). The window then
continues from that state. After the window, one more step runs through
``step`` from the state the window left (the parameters and Adam's
moments and step count, kept aside first), and the comparison holds that
step to the reference's step from the same state: its loss, its gradient
as Adam's first moment works it out, and the parameters' change. The
reference cannot follow the window's thousands of steps; the first steps
check the start from the seed, and this one a step of the window's own
state. Full-batch training has one batch, the whole graph, every step.
"""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch
from torch.profiler import record_function

from perfbench import compare, graphs, plants
from perfbench.counts import gcn as counts
from perfbench.reference import gcn as reference


def nll(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The mean over nodes of -log softmax(z)[y]."""
    return -torch.log_softmax(z, dim=1).gather(1, y[:, None]).mean()


class Entry:
    CONTROLS = ("tf32", "tf32-tc")
    #: faults planted in the timed path, by name (``replay``)
    FAULTS = {"half_batch": plants.half_batch, "state_unchanged": plants.state_unchanged}

    def __init__(self, config: Dict[str, object], traffic: Dict[str, object], seed: int, device):
        import repro_torch
        import repro_torch.optim
        from repro_torch import kernels
        from repro_torch.relational import gcn_conv, rel_linear

        t0 = time.perf_counter()
        self._ops = (gcn_conv, rel_linear)
        self._optim = repro_torch.optim  # looked up at each step, where a planted fault patches it
        self._kernels = kernels
        self.config, self.traffic = config, traffic
        self.opt_args = dict(config["optimizer"])
        dev = torch.device(device)
        gen = graphs.generator(dev, seed)
        f, h, c = config["features"], config["hidden"], config["classes"]
        self.keys, self.w, self.x = graphs.draw_graph(gen, config["nodes"], config["edges"], f)
        self.y = graphs.smooth_labels(gen, self.keys, self.w, self.x, c)
        self.params0 = {
            "w1": torch.randn(f, h, generator=gen, device=dev) * f ** -0.5,
            "w2": torch.randn(h, c, generator=gen, device=dev) * h ** -0.5,
        }
        t1 = time.perf_counter()
        self.db = repro_torch.Database(device=dev)
        self.losses = []
        self.start = self._from_start()
        self.late_from = self.late = None
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.stages = {"inputs_s": t1 - t0, "checked_steps_s": time.perf_counter() - t1}

    def step(self) -> None:
        gcn_conv, rel_linear = self._ops
        lr = self.opt_args["lr"]
        betas = dict(b1=self.opt_args["b1"], b2=self.opt_args["b2"], eps=self.opt_args["eps"])
        with self.db.activate():
            with record_function("port:forward"):
                p = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
                h0 = gcn_conv(self.x, self.keys, self.w)
                z1 = rel_linear(h0, p["w1"])
                h1 = gcn_conv(torch.relu(z1), self.keys, self.w)
                loss = nll(rel_linear(h1, p["w2"]), self.y)
            with record_function("port:backward"):
                grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            with record_function("port:optimizer"):
                self.params, self.opt = self._optim.adam_update(self.params, grads, self.opt, lr=lr, **betas)
        self.losses.append(loss.detach())

    def _from_start(self) -> Dict[str, object]:
        """The first ``checked_steps`` steps from the seed's parameters and a
        fresh optimizer; their answers. The state they leave stays."""
        self.params = {k: v.clone() for k, v in self.params0.items()}
        self.opt = self._optim.adam_init(self.params)
        self.losses, mu1 = [], None
        for i in range(int(self.traffic["checked_steps"])):
            self.step()
            if i == 0:
                mu1 = {k: v.clone() for k, v in self.opt["mu"].items()}
        b1 = self.opt_args["b1"]
        out = {
            "losses": [float(v) for v in self.losses],
            "grad1": {k: m / (1 - b1) for k, m in mu1.items()},
            "change": {k: self.params[k] - self.params0[k] for k in self.params0},
        }
        self.losses = []
        return out

    def _late_step(self) -> Dict[str, object]:
        """One step from the state kept in ``late_from``: its answers (the
        gradient from Adam's first moment before and after, in f64)."""
        s = self.late_from
        self.params = {k: v.clone() for k, v in s["params"].items()}
        self.opt = {"mu": {k: v.clone() for k, v in s["mu"].items()},
                    "nu": {k: v.clone() for k, v in s["nu"].items()}, "step": s["step"]}
        self.step()
        b1 = self.opt_args["b1"]
        return {
            "losses": [float(self.losses.pop())],
            "grad1": {k: (m.double() - b1 * s["mu"][k].double()) / (1 - b1) for k, m in self.opt["mu"].items()},
            "change": {k: self.params[k] - s["params"][k] for k in self.params},
        }

    def after_window(self) -> None:
        """Keep the state the window left, and run one more step from it."""
        self.late_from = {
            "params": {k: v.clone() for k, v in self.params.items()},
            "mu": {k: v.clone() for k, v in self.opt["mu"].items()},
            "nu": {k: v.clone() for k, v in self.opt["nu"].items()},
            "step": int(self.opt["step"]),
        }
        self.late = self._late_step()

    def replay(self, fault) -> Dict[str, object]:
        """The answers with ``fault`` planted: the first steps from the seed
        and the step after the window again; the state is put back."""
        keep = self.params, self.opt, self.losses
        with fault():
            out = {"start": self._from_start(), "late": self._late_step()}
        self.params, self.opt, self.losses = keep
        return out

    def counters(self) -> Dict[str, object]:
        return {"launches": self._kernels.launch_counts()}

    def least(self) -> Dict[str, float]:
        c = self.config
        ops = counts.train_step(c["nodes"], c["edges"] + c["nodes"], c["features"], c["hidden"], c["classes"])
        return counts.least_seconds(ops, (0.0, 0.0), counts.peaks())

    def nonfinite(self) -> int:
        """The window's steps whose loss is not finite."""
        if not self.losses:
            return 0
        return int((~torch.isfinite(torch.stack(self.losses))).sum())

    def release(self) -> None:
        """Free the program's state; keep the inputs and what is compared."""
        del self.db, self.params, self.opt
        self.losses = []
        gc.collect()
        if self.x.is_cuda:
            torch.cuda.empty_cache()

    def observed(self) -> Dict[str, object]:
        return {"start": self.start, "late": self.late}

    def reference(self, precision: str = "f64") -> Dict[str, object]:
        prec = reference.Precision(precision)
        args = (self.x, self.keys, self.w, self.y)
        out = {"start": reference.train_steps(*args, self.params0, steps=len(self.start["losses"]),
                                              prec=prec, **self.opt_args)}
        if self.late_from is not None:
            s = self.late_from
            out["late"] = reference.train_steps(*args, s["params"], steps=1, prec=prec,
                                                moments=s, done=s["step"], **self.opt_args)
        return out

    def control(self, precision: str) -> Dict[str, object]:
        return self.reference(precision)

    def gaps(self, obs: Dict[str, object], ref: Dict[str, object]) -> Dict[str, float]:
        """``loss``, ``grad1``, ``change`` of the first steps; ``late_loss``,
        ``late_grad``, ``late_change`` of the step after the window."""
        out = compare.train_gaps(obs["start"], ref["start"])
        if "late" in ref:
            late = compare.train_gaps(obs["late"], ref["late"])
            out.update({"late_loss": late["loss"], "late_grad": late["grad1"], "late_change": late["change"]})
        return out

    def compare(self) -> Dict[str, float]:
        return self.gaps(self.observed(), self.reference())
