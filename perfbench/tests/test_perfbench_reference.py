"""The plain reference against the program's torch tier on the CPU, at a
tiny graph."""

import pytest
import torch

from perfbench import compare, graphs
from perfbench.entries import gcn_query_waves
from perfbench.reference import gcn as reference
from perfbench.tests import tiny


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0, 2 ** -30 * 1.0007], dtype=torch.float32)
    got = reference.round_tf32(x)
    assert got.tolist()[:4] == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]
    assert ((got.view(torch.int32) & 0x1FFF) == 0).all()


def _graph(seed=3, n=400, e=3000, f=8):
    gen = graphs.generator("cpu", seed)
    keys, w, x = graphs.draw_graph(gen, n, e, f)
    return gen, keys, w, x


def test_training_steps_against_the_torch_tier():
    import repro_torch
    from repro_torch.optim import adam_init, adam_update
    from repro_torch.relational import gcn_conv, rel_linear

    gen, keys, w, x = _graph()
    y = graphs.smooth_labels(gen, keys, w, x, 4)
    p0 = {"w1": torch.randn(8, 16, generator=gen) * 0.3, "w2": torch.randn(16, 4, generator=gen) * 0.25}
    params, opt = dict(p0), adam_init(p0)
    losses, grad1 = [], None
    with repro_torch.Database(device="cpu", dispatch="torch").activate():
        for _ in range(3):
            p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            h1 = gcn_conv(torch.relu(rel_linear(gcn_conv(x, keys, w), p["w1"])), keys, w)
            loss = -torch.log_softmax(rel_linear(h1, p["w2"]), 1).gather(1, y[:, None]).mean()
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            grad1 = grad1 or grads
            params, opt = adam_update(params, grads, opt, lr=0.05)
            losses.append(float(loss.detach()))
    ref = reference.train_steps(x, keys, w, y, p0, steps=3, lr=0.05, b1=0.9, b2=0.999, eps=1e-8,
                                prec=reference.Precision("f64"))
    assert losses == pytest.approx(ref["losses"], rel=1e-6)
    for k in p0:
        torch.testing.assert_close(grad1[k].double(), ref["grad1"][k], rtol=1e-5, atol=1e-7)
        torch.testing.assert_close((params[k] - p0[k]).double(), ref["change"][k], rtol=1e-4, atol=1e-6)


def test_gradient_query_against_the_torch_tier():
    import repro_torch

    _, keys, w, x = _graph(seed=4)
    n = x.shape[0]
    db = repro_torch.Database(device="cpu", dispatch="torch")
    db.put("Edge", repro_torch.CooRelation(keys, w, (n, n)))
    db.put("Node", x, keys=("node",))
    out, grads = db.query(gcn_query_waves.loss_query(n)).step(wrt=("Edge", "Node"))
    ref = reference.query_step(keys, w, x, reference.Precision("f64"), chunk=1000)
    assert float(out.data) == pytest.approx(ref["loss"], rel=1e-6)
    torch.testing.assert_close(grads["Node"].data.double(), ref["dnode"], rtol=1e-5, atol=1e-7)
    # the in-core step returns dEdge in the edges' own order; the reference
    # gives it by destination
    order = reference.dst_order(keys)
    torch.testing.assert_close(grads["Edge"].values[order].double(), ref["dedge"], rtol=1e-5, atol=1e-7)
    gaps = compare.query_gaps({"losses": [float(out.data)], "dnode": grads["Node"].data,
                               "dedge": grads["Edge"].values[order]}, ref)
    assert max(gaps.values()) < 1e-5


def test_the_seed_draws_the_same_graph():
    a, b = _graph(seed=2 ** 31 + 5)[1:], _graph(seed=2 ** 31 + 5)[1:]
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(_graph(seed=6)[3], a[2])
