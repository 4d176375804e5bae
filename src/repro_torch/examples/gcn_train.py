"""End-to-end GCN node-classification training (paper §6, Tables 2–3).

A two-layer graph convolutional network where message passing is the
paper's three-way join (Node ⋈ Edge ⋈ Node) + Σ-by-destination, executed
through the relational ops whose backward passes are RA-autodiff-generated
gradient queries (reversed-edge convolution for ∂h, per-edge dot for ∂w),
with Adam. The reference's ``examples/gcn_train.py`` step for step: the
same graph, labels and initial weights from the same numpy seeds.

Supports full-graph training (the mode only RA-GCN could reach in the
paper) and mini-batch training, mirroring the paper's two rows. The
reference's ``--mesh`` waits for multi-GPU planning (ROADMAP.md).

Run:  PYTHONPATH=src python -m repro_torch.examples.gcn_train [--nodes 2048] [--edges 16384]
      [--epochs 30] [--mode full|minibatch] [--device cpu]

It runs on the CUDA device unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Tuple

import numpy as np
import torch

import repro_torch
from repro_torch.data import synthetic_graph
from repro_torch.optim import adam_init, adam_update
from repro_torch.relational import gcn_conv, rel_linear


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--edges", type=int, default=16384)
    ap.add_argument("--feat", type=int, default=64)
    ap.add_argument("--labels", type=int, default=16)
    ap.add_argument("--hidden", type=int, default=256)   # paper: D=256
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--mode", choices=("full", "minibatch"), default="full")
    ap.add_argument("--batch", type=int, default=1024)   # paper: B=1024
    ap.add_argument("--device", default=None, help='default "cuda"')
    return ap.parse_args(argv)


def train(args) -> List[Tuple[float, float]]:
    """Run the epochs of ``args``; returns (loss, accuracy) of every step."""
    db = repro_torch.Database(device=args.device)
    dev = db.device
    g = synthetic_graph(args.nodes, args.edges, args.feat, args.labels, seed=0)
    keys = torch.as_tensor(g["edge_keys"], device=dev)
    w = torch.as_tensor(g["edge_w"], device=dev)
    x = torch.as_tensor(g["x"], device=dev)

    # The edge relation is registered so the catalog tracks its key-domain
    # statistics (distinct src/dst counts, nnz, density).
    db.put("Edge", repro_torch.CooRelation(keys, w, (args.nodes, args.nodes)),
           keys=("src", "dst"))
    print(f"catalog Edge: keys={db.schema('Edge')}  {db.stats('Edge')}")
    rng = np.random.default_rng(0)
    proj = rng.normal(size=(args.feat, args.labels)).astype(np.float32)
    with db.activate(), torch.no_grad():
        # learnable labels (2-hop-smoothed linear function of the features)
        smooth = gcn_conv(gcn_conv(x, keys, w), keys, w).cpu().numpy()
    y = torch.as_tensor(np.argmax(smooth @ proj, axis=1).astype(np.int64), device=dev)

    params = {
        "w1": torch.as_tensor(rng.normal(size=(args.feat, args.hidden)).astype(np.float32),
                              device=dev) * (args.feat ** -0.5),
        "w2": torch.as_tensor(rng.normal(size=(args.hidden, args.labels)).astype(np.float32),
                              device=dev) * (args.hidden ** -0.5),
    }
    opt = adam_init(params)

    def forward(p):
        h = gcn_conv(x, keys, w)                  # join-agg message passing
        h = torch.relu(rel_linear(h, p["w1"]))
        h = gcn_conv(h, keys, w)
        return rel_linear(h, p["w2"])

    def step(params, opt, node_ids):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits = forward(p)[node_ids]
        yy = y[node_ids]
        loss = -torch.log_softmax(logits, dim=1).gather(1, yy[:, None]).mean()
        acc = (logits.argmax(1) == yy).float().mean()
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        params, opt = adam_update(params, grads, opt, lr=args.lr)
        return params, opt, float(loss.detach()), float(acc)

    all_nodes = torch.arange(args.nodes, device=dev)
    print(f"mode={args.mode}  |V|={args.nodes} |E|={keys.shape[0]} "
          f"feat={args.feat} hidden={args.hidden}  device={dev}")
    out = []
    with db.activate():
        for epoch in range(args.epochs):
            t0 = time.time()
            if args.mode == "full":
                params, opt, loss, acc = step(params, opt, all_nodes)
                out.append((loss, acc))
            else:
                perm = np.random.default_rng(epoch).permutation(args.nodes)
                for i in range(0, args.nodes, args.batch):
                    ids = torch.as_tensor(perm[i : i + args.batch], device=dev)
                    params, opt, loss, acc = step(params, opt, ids)
                    out.append((loss, acc))
            dt = time.time() - t0
            if epoch % 5 == 0 or epoch == args.epochs - 1:
                print(f"epoch {epoch:3d}  loss {loss:.4f}  acc {acc:.3f}  {dt*1e3:.0f} ms")
    return out


def main(argv=None) -> None:
    out = train(parse_args(argv))
    if not out[-1][1] > 0.5:
        raise AssertionError("training failed to learn")
    print("done.")


if __name__ == "__main__":
    main()
