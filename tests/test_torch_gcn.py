"""The slice as a whole: the two-layer GCN training step of
examples/gcn_train.py (gcn_conv → rel_linear → relu → gcn_conv →
rel_linear → log-softmax NLL) in the JAX package and in the port, from the
same graph, labels and weights (numpy, carried across by
``repro_torch.convert``).

The JAX step runs under ``repro.Database(dispatch="interpret")``, which
reaches the Pallas kernels in interpret mode; the port's under
``repro_torch.Database(device="cpu")``, where the kernel wrappers take
their plain versions. Loss and the w1/w2 gradients agree at atol 1e-5.
Three Adam steps then agree at rtol 1e-4: Adam's first step is nearly
sign(g), which turns ulp-level gradient differences into visible
parameter differences, so the bound is looser there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro
import repro_torch
from repro.data import synthetic_graph as jax_synthetic_graph
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro.relational import gcn_conv as jax_gcn_conv
from repro.relational import rel_linear as jax_rel_linear
from repro_torch import convert, kernels
from repro_torch.data import synthetic_graph
from repro_torch.optim import adam_init, adam_update
from repro_torch.relational import gcn_conv, rel_linear

N, E, FEAT, LABELS, HIDDEN, LR = 64, 256, 8, 4, 16, 0.05


def _problem():
    g = synthetic_graph(N, E, FEAT, LABELS, seed=0)
    keys, w, x = g["edge_keys"], g["edge_w"], g["x"]
    # learnable labels as in examples/gcn_train.py: a 2-hop-smoothed linear
    # function of the features (computed here with a dense adjacency)
    adj = np.zeros((N, N), np.float64)
    np.add.at(adj, (keys[:, 1], keys[:, 0]), w)
    rng = np.random.default_rng(0)
    proj = rng.normal(size=(FEAT, LABELS))
    y = np.argmax(adj @ adj @ x @ proj, axis=1).astype(np.int32)
    params = {
        "w1": (rng.normal(size=(FEAT, HIDDEN)) * FEAT ** -0.5).astype(np.float32),
        "w2": (rng.normal(size=(HIDDEN, LABELS)) * HIDDEN ** -0.5).astype(np.float32),
    }
    return g, y, params


def test_graph_generators_agree():
    a = synthetic_graph(N, E, FEAT, LABELS, seed=0)
    b = jax_synthetic_graph(N, E, FEAT, LABELS, seed=0)
    for k in ("edge_keys", "edge_w", "x", "y"):
        np.testing.assert_array_equal(a[k], np.asarray(b[k]))


def test_gcn_training_step_matches_reference():
    g, y, params = _problem()

    # -- the reference, on the Pallas kernels in interpret mode -------------
    jkeys = jnp.asarray(g["edge_keys"], jnp.int32)
    jw = jnp.asarray(g["edge_w"], jnp.float32)
    jx = jnp.asarray(g["x"], jnp.float32)
    jy = jnp.asarray(y)

    def jax_loss(p):
        h = jax_gcn_conv(jx, jkeys, jw)
        h = jax.nn.relu(jax_rel_linear(h, p["w1"]))
        h = jax_gcn_conv(h, jkeys, jw)
        logp = jax.nn.log_softmax(jax_rel_linear(h, p["w2"]))
        return -jnp.mean(jnp.take_along_axis(logp, jy[:, None], axis=1))

    jparams = {k: jnp.asarray(v, jnp.float32) for k, v in params.items()}
    jopt = jax_adam_init(jparams)
    jlosses, jgrads0 = [], None
    with repro.Database(dispatch="interpret").activate():
        for step in range(4):
            loss, grads = jax.value_and_grad(jax_loss)(jparams)
            jlosses.append(float(loss))
            if step == 0:
                jgrads0 = {k: np.asarray(v) for k, v in grads.items()}
            jparams, jopt = jax_adam_update(jparams, grads, jopt, lr=LR)

    # -- the port, on the CPU ---------------------------------------------
    dev = "cpu"
    tkeys = convert.tensor(g["edge_keys"], dev, torch.int32)
    tw = convert.tensor(g["edge_w"], dev)
    tx = convert.tensor(g["x"], dev)
    ty = convert.tensor(y, dev).long()

    def loss_fn(p):
        h = gcn_conv(tx, tkeys, tw)
        h = torch.relu(rel_linear(h, p["w1"]))
        h = gcn_conv(h, tkeys, tw)
        logp = torch.log_softmax(rel_linear(h, p["w2"]), dim=1)
        return -logp.gather(1, ty[:, None]).mean()

    tparams = convert.params(params, dev)
    topt = adam_init(tparams)
    tlosses = []
    kernels.reset_launch_counts()
    with repro_torch.Database(device=dev).activate():
        for step in range(4):
            p = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
            loss = loss_fn(p)
            loss.backward()
            grads = {k: v.grad for k, v in p.items()}
            tlosses.append(float(loss.detach()))
            if step == 0:
                np.testing.assert_allclose(tlosses[0], jlosses[0], atol=1e-5)
                for k in ("w1", "w2"):
                    np.testing.assert_allclose(grads[k].numpy(), jgrads0[k], atol=1e-5)
            tparams, topt = adam_update(tparams, grads, topt, lr=LR)
    assert sum(kernels.launch_counts().values()) == 0
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]


def test_backward_runs_in_the_forward_session():
    """The backward of gcn_conv and rel_linear runs in the session that ran
    the forward, even where the ambient session is another one by then:
    autograd runs the backward of CUDA tensors on a thread of its own."""
    g, y, params = _problem()
    keys = convert.tensor(g["edge_keys"], "cpu", torch.int32)
    w = convert.tensor(g["edge_w"], "cpu")
    x = convert.tensor(g["x"], "cpu")
    w1 = convert.tensor(params["w1"], "cpu").requires_grad_(True)
    db = repro_torch.Database(device="cpu", dispatch="ref")
    with db.activate():
        h = gcn_conv(torch.relu(rel_linear(x, w1)), keys, w)
    # outside the block: the ambient session would be a default Database(),
    # on "cuda"
    h.sum().backward()
    adj = torch.zeros(N, N)
    adj.index_put_((keys[:, 1].long(), keys[:, 0].long()), w, accumulate=True)
    w1_plain = w1.detach().clone().requires_grad_(True)
    (adj @ torch.relu(x @ w1_plain)).sum().backward()
    torch.testing.assert_close(w1.grad, w1_plain.grad, atol=1e-5, rtol=0)
