"""The port's Database session (repro_torch.Database) against the JAX
package's: the FRA logistic regression (paper §2.3) stepped through
``db.query(...).step()`` in both, one lowering per signature, the donated
guard, and the CUDA default of the entry point."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import fra as jfra
from repro.core import keys as jkeys
from repro.core import kernels as jkernels
from repro_torch.core import fra as tfra
from repro_torch.core import keys as tkeys
from repro_torch.core import kernels as tkernels
from repro_torch.core.session import CatalogError

ATOL = 1e-5


def logreg_query(fra, K, k):
    mm = fra.Agg(
        K.project_key(0), k.ADD,
        fra.Join(K.eq_pred((1, 0)), K.jproj(K.L(0), K.L(1)), k.MUL,
                 fra.const("Rx", 2), fra.scan("theta", 1)),
    )
    pred = fra.Select(K.TRUE, K.identity_key(1), k.LOGISTIC, mm)
    loss = fra.Agg(
        K.EMPTY_KEY, k.ADD,
        fra.Join(K.eq_pred((0, 0)), K.jproj(K.L(0)), k.XENT, pred, fra.const("Ry", 1)),
    )
    return fra.Query(loss, inputs=("theta",))


def _data(n=16, m=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, m)).astype(np.float32)
    y = (rng.uniform(size=n) > 0.5).astype(np.float32)
    theta = (rng.normal(size=m) * 0.1).astype(np.float32)
    return X, y, theta


def _put_all(db, X, y, theta, asarray):
    db.put("Rx", asarray(X), keys=("row", "col"))
    db.put("Ry", asarray(y), keys=("row",))
    db.put("theta", asarray(theta), keys=("col",))


def test_logreg_steps_match_reference():
    X, y, theta = _data()
    jdb = repro.Database()
    _put_all(jdb, X, y, theta, lambda a: jnp.asarray(a, jnp.float32))
    tdb = repro_torch.Database(device="cpu")
    _put_all(tdb, X, y, theta, torch.tensor)
    jh = jdb.query(logreg_query(jfra, jkeys, jkernels))
    th = tdb.query(logreg_query(tfra, tkeys, tkernels))
    lr = 0.05
    losses = []
    for _ in range(5):
        jl, jg = jh.step()
        tl, tg = th.step()
        np.testing.assert_allclose(float(tl.data), float(jl.data), atol=ATOL)
        np.testing.assert_allclose(
            tg["theta"].data.numpy(), np.asarray(jg["theta"].data), atol=ATOL
        )
        losses.append(float(tl.data))
        # the same update on both sides, from each side's own gradient
        jdb.put("theta", jdb.get("theta").data - lr * jg["theta"].data)
        tdb.put("theta", tdb.get("theta").data - lr * tg["theta"].data)
    assert losses[-1] < losses[0]
    # one lowering for the one signature, across all five steps
    assert th.lower_count == 1
    assert th.resolutions and set(th.resolutions.values()) == {"torch"}


def test_forward_grad_and_ref_dispatch_agree():
    X, y, theta = _data(seed=3)
    dbs = []
    for dispatch in (None, "ref"):
        db = repro_torch.Database(device="cpu", dispatch=dispatch)
        _put_all(db, X, y, theta, torch.tensor)
        dbs.append(db)
    q = logreg_query(tfra, tkeys, tkernels)
    h0, h1 = dbs[0].query(q), dbs[1].query(q)
    torch.testing.assert_close(h0.forward().data, h1.forward().data, atol=ATOL, rtol=0)
    torch.testing.assert_close(
        h0.grad()["theta"].data, h1.grad()["theta"].data, atol=ATOL, rtol=0
    )
    assert set(h1.resolutions.values()) == {"ref"}


def test_donated_relation_must_be_put_again():
    X, y, theta = _data()
    db = repro_torch.Database(device="cpu")
    _put_all(db, X, y, theta, torch.tensor)
    h = db.query(logreg_query(tfra, tkeys, tkernels))
    _, grads = h.step(donate=("theta",))
    with pytest.raises(CatalogError, match="donated"):
        db.get("theta")
    db.put("theta", torch.tensor(theta) - 0.1 * grads["theta"].data)
    h.step()


def test_database_defaults_to_cuda_and_refuses_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default session is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.Database()
    assert repro_torch.Database(device="cpu").device.type == "cpu"
