"""The operation and byte counts, by hand at small shapes and at the
cells' shapes."""

import pytest

from perfbench.counts import gcn as counts


def test_join_aggregate_by_hand():
    # 10 edges, 4 nodes in, 3 out, width 2: 10 * 12 bytes of edges,
    # (4 + 3) * 2 * 4 bytes of rows, 2 * 10 * 2 operations
    assert counts.aggregate("a", 10, 4, 3, 2) == ("a", 40.0, 120 + 56)
    assert counts.edge_grad("g", 10, 4, 2) == ("g", 40.0, 80 + 64 + 40)
    assert counts.product("p", 2, 3, 4) == ("p", 48.0, (6 + 12 + 8) * 4)
    assert counts.elementwise("e", 5, 2, 1, ops=3) == ("e", 15.0, 60)


def test_train_step_by_hand():
    ops = counts.train_step(nodes=2, edges=3, feat=1, hidden=2, classes=1)
    flops, nbytes = counts.totals(ops)
    want_bytes = (
        (3 * 12 + 4 * 1 * 4)        # conv1
        + (2 + 2 + 4) * 4           # z1
        + 4 * 2 * 4                 # relu
        + (3 * 12 + 4 * 2 * 4)      # conv2
        + (4 + 2 + 2) * 4           # z2
        + 2 * 4 + 2 * 8             # loss
        + 2 * 2 * 4 + 2 * 8         # dz2
        + (4 + 2 + 2) * 4           # dW2
        + (2 + 2 + 4) * 4           # dh1
        + (3 * 12 + 4 * 2 * 4)      # da1
        + 4 * 3 * 4                 # dz1
        + (2 + 4 + 2) * 4           # dW1
        + 4 * 7 * 4                 # adam over 4 parameters
    )
    assert nbytes == want_bytes
    want_flops = (2 * 3 * 1 + 2 * 2 * 1 * 2 + 4 + 2 * 3 * 2 + 2 * 2 * 2 * 1 + 4 * 2 + 3 * 2
                  + 2 * 2 * 2 * 1 + 2 * 2 * 1 * 2 + 2 * 3 * 2 + 4 + 2 * 1 * 2 * 2 + 12 * 4)
    assert flops == want_flops


def test_the_cells_shapes():
    arxiv = counts.train_step(169_343, 1_166_243 + 169_343, 128, 256, 40)
    assert counts.totals(arxiv)[1] == pytest.approx(2.99e9, rel=0.01)
    wrt = ("Edge", "Node")
    products = counts.query_step(2_449_029, 61_859_140 + 2_449_029, 256, wrt)
    assert counts.totals(products)[1] == pytest.approx(24.9e9, rel=0.01)
    least = counts.least_seconds(products, counts.link_bytes(61_859_140 + 2_449_029, wrt), counts.peaks())
    assert least["link_s"] == pytest.approx(771_698_028 / 64e9)
    assert least["chip_s"] == least["link_s"] > least["device_s"]
    node_only = counts.query_step(2_449_029, 64_308_169, 256, ("Node",))
    assert counts.totals(node_only)[1] < counts.totals(products)[1]
