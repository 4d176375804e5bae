"""The benchmark's graphs, drawn on the device from a seed.

The distribution of ``repro_torch.data.synthetic_graph`` (and of the JAX
package's generator it mirrors), drawn with a ``torch.Generator`` on the
device in a few large calls: random sources, destinations
``floor(Lomax(2) * n / 8) mod n`` (numpy's ``pareto(2.0)`` is
``exp(Exp(rate 2)) - 1``), so in-degrees are skewed; one self loop a node;
weights ``1 / sqrt(deg(src) * deg(dst))``; standard normal features. The
same seed gives the same bits on the same device.
"""

from __future__ import annotations

import torch


def generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number:
    taken modulo 2**64)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def draw_graph(gen: torch.Generator, n_nodes: int, n_edges: int, n_feat: int):
    """(keys (E, 2) int32 <src, dst>, weights (E,) f32, features (n, n_feat)
    f32), with E = n_edges + n_nodes (the self loops last)."""
    dev = gen.device
    src = torch.randint(0, n_nodes, (n_edges,), generator=gen, device=dev)
    lomax = torch.empty(n_edges, dtype=torch.float64, device=dev).exponential_(2.0, generator=gen)
    dst = (lomax.exp_().sub_(1) * (n_nodes / 8)).long() % n_nodes
    del lomax
    loops = torch.arange(n_nodes, device=dev)
    src, dst = torch.cat([src, loops]), torch.cat([dst, loops])
    deg = torch.bincount(dst, minlength=n_nodes) + torch.bincount(src, minlength=n_nodes)
    w = 1.0 / torch.sqrt((deg[src] * deg[dst]).double()).float()
    keys = torch.stack([src, dst], dim=1).to(torch.int32)
    del src, dst, deg
    x = torch.randn(n_nodes, n_feat, generator=gen, device=dev)
    return keys, w, x


def smooth_labels(gen: torch.Generator, keys, w, x, n_classes: int) -> torch.Tensor:
    """Learnable labels, as ``examples/gcn_train.py`` makes them: the argmax
    of a random projection of the 2-hop smoothed features. The smoothing
    runs in f64 here, so that the labels of a seed do not hang on the
    order in which atomics add."""
    src, dst = keys[:, 0].long(), keys[:, 1].long()
    wd = w.double()[:, None]
    h = x.double()
    for _ in range(2):
        out = torch.zeros_like(h)
        out.index_add_(0, dst, wd * h[src])
        h = out
    proj = torch.randn(x.shape[1], n_classes, generator=gen, device=x.device, dtype=torch.float64)
    return torch.argmax(h @ proj, dim=1)
