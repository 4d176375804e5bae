"""A relation committed with both mesh axes on one dim runs the placed walk.

``Rx`` of the SQL logistic regression is committed as a ``DTensor`` placed
``[Shard(0), Shard(0)]`` on the 2 × 2 host mesh: its rows cut over the
("data", "model") fold, rank (d, m) holding block 2·d + m. The step's plan
wants ``Rx`` as ``P("data", "model")`` (rows on "data", columns on
"model"), so the executable gathers the fold whole (the model group's
slabs, then the data group's) and cuts it as planned. Its loss and
gradients must equal the mesh-less step's within the mesh rule of
tests/test_torch_oocore_mesh.py (atol 1e-5 plus 4 f32 roundings of the
value: the ranks' partial sums are added in another order), and the
reference's. A committed layout read in the wrong block order (the planted
fault) must miss by far more than that.

The ranks start once for the module (``launch.mesh.start_ranks``, 4
``gloo`` ranks on the CPU) and run ``tests/torch_mesh_fold_workers.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import repro
import torch_mesh_fold_workers as W
from repro_torch.launch.mesh import start_ranks

ATOL = 1e-5
RTOL = 4 * 2.0 ** -24


@pytest.fixture(scope="module")
def ranks():
    return start_ranks(W.fold_checks, 4, backend="gloo", device="cpu")


@pytest.fixture(scope="module")
def reference():
    X, y, theta = W.logreg_data()
    db = repro.Database()
    db.put("Rx", jnp.asarray(X), keys=("row", "col"))
    db.put("Ry", jnp.asarray(y), keys=("row",))
    db.put("theta", jnp.asarray(theta), keys=("col",))
    loss, grads = db.sql(W.LOGREG_SQL, wrt=W.WRT).step()
    return {"loss": np.asarray(loss.data),
            **{k: np.asarray(g.data) for k, g in sorted(grads.items())}}


def close(got, want) -> bool:
    return all(np.allclose(got[k], want[k], atol=ATOL, rtol=RTOL) for k in want)


@pytest.mark.parametrize("rank", range(4))
def test_a_folded_relation_runs_the_placed_walk(ranks, rank):
    r = ranks[rank]
    assert r["planned"] == ("data", "model")
    for k in r["want"]:
        np.testing.assert_allclose(r["got"][k], r["want"][k], atol=ATOL, rtol=RTOL, err_msg=k)
    # the fold is a committed layout other than the plan's: the whole of Rx
    # is booked as moved
    assert r["moved"] == r["rx_bytes"]


def test_the_folded_step_equals_the_reference(ranks, reference):
    got = ranks[0]["got"]
    assert sorted(got) == sorted(reference)
    for k in reference:
        np.testing.assert_allclose(got[k], reference[k], atol=ATOL, rtol=RTOL, err_msg=k)


def test_the_ranks_agree_bit_for_bit(ranks):
    for r in ranks[1:]:
        for k, v in ranks[0]["got"].items():
            np.testing.assert_array_equal(r["got"][k], v, err_msg=k)


def test_blocks_in_the_wrong_order_are_caught(ranks):
    for r in ranks:
        assert not close(r["planted"], r["want"])
        assert abs(float(r["planted"]["loss"]) - float(r["want"]["loss"])) > 1e3 * ATOL
