"""Synthetic graph generator for the GCN experiments (paper §6 scaled to
this container): power-law-ish degree distribution, normalized edge
weights with self loops (the paper's Edge relation stores normalized
weights including self-loops).

The same numpy generator as the reference's ``data/graphs.py``, returning
numpy arrays: the same seed gives both packages the same graph."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_graph(
    n_nodes: int,
    n_edges: int,
    n_feat: int,
    n_labels: int,
    seed: int = 0,
) -> dict:
    rng = np.random.default_rng(seed)
    # preferential-attachment-ish destinations
    src = rng.integers(0, n_nodes, size=n_edges)
    dst = (rng.pareto(2.0, size=n_edges) * n_nodes / 8).astype(np.int64) % n_nodes
    # add self loops
    loops = np.arange(n_nodes)
    src = np.concatenate([src, loops])
    dst = np.concatenate([dst, loops])
    # symmetric normalization w = 1/sqrt(deg(src)·deg(dst))
    deg = np.bincount(dst, minlength=n_nodes) + np.bincount(src, minlength=n_nodes)
    w = 1.0 / np.sqrt(deg[src] * deg[dst]).astype(np.float32)
    keys = np.stack([src, dst], axis=1).astype(np.int32)
    x = rng.normal(size=(n_nodes, n_feat)).astype(np.float32)
    y = rng.integers(0, n_labels, size=n_nodes).astype(np.int32)
    return {
        "edge_keys": keys,
        "edge_w": w,
        "x": x,
        "y": y,
        "n_nodes": n_nodes,
    }
