"""A pod axis, on 4 ``gloo`` ranks on the CPU: the reduced olmoe-1b-7b
trained one Adam step on a 2 × 2 × 1 ("pod", "data", "model") mesh — the
batch cut over the ("pod", "data") fold, FSDP over "data" alone (at a 32
KiB threshold), the gradients summed over "pod" after the FSDP
reduce-scatters — and served on it, held to the one-process port step and
to the reference's one-device step (tests/torch_lm_mesh_parity.py's
bound); the ranks to each other bit for bit; the pod all-reduce left out
planted. In this process: every arch of ``ARCH_IDS`` placed on a 1 × 4, a
2 × 2 and a 2 × 2 × 1 mesh given by its axis sizes (the dry run's), and
``param_pspecs``/``batch_pspecs`` of the reduced archs on pod meshes
given so, against the reference's on a ``jax.sharding.AbstractMesh``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

import torch_lm_mesh_parity as P
import torch_lm_mesh_zoo_parity as ZP
import torch_lm_mesh_zoo_workers as Z
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jsh
from repro.models import build_model as jax_build_model
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import reference_leaf
from repro_torch.launch import sharding
from repro_torch.models.model import param_shapes

SUITE = Z.SUITES["pod"]
ARCH = SUITE.archs[0]
MESH = SUITE.meshes[0][0]
#: meshes given by their axis sizes: 1 × 4, 2 × 2, 2 × 2 × 1
MAPPED = {"1x4": {"data": 1, "model": 4}, "2x2": {"data": 2, "model": 2},
          "2x2x1": {"pod": 2, "data": 2, "model": 1}}
#: pod meshes for the specs: the test's own and one that splits "model"
POD_MESHES = {"2x2x1": (2, 2, 1), "2x2x2": (2, 2, 2)}


@pytest.fixture(scope="module")
def runs():
    return ZP.start("pod", ZP.weights(SUITE))


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


@pytest.fixture(scope="module")
def rec(ranks):
    return ranks[0][ARCH]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1][ARCH]


def test_train_step_on_the_pod_mesh_equals_the_one_process_step(rec):
    assert P.train_misses(rec[MESH]["train"], rec["one"]["train"]) == []


def test_train_step_on_the_pod_mesh_equals_the_reference(rec, reference):
    assert P.reference_misses(rec[MESH]["train"], reference) == []


def test_serving_on_the_pod_mesh_equals_the_one_process_step(rec, reference):
    assert P.close(rec[MESH]["serve"]["logits"], rec["one"]["serve"]["logits"])
    assert P.close(rec[MESH]["serve"]["logits"], reference["logits"])


def test_the_ranks_sit_on_the_pod_and_data_axes_and_agree(ranks, rec):
    """Rank r sits at pod r // 2 and data r % 2, its batch index the fold's;
    the ranks' steps are bit-equal, their caches hold a quarter of the
    rows."""
    for r in ranks:
        coords = r[ARCH][MESH]["coords"]
        i = r["rank"]
        assert (coords["pod"], coords["data"], coords["model"], coords["batch"]) == (i // 2, i % 2, 0, i)
        assert r[ARCH][MESH]["shard"]
        assert r[ARCH][MESH]["cache0"]["kv/k"][0] == SUITE.b // 4
        t0, t = rec[MESH]["train"], r[ARCH][MESH]["train"]
        assert (t["loss"], t["norm"]) == (t0["loss"], t0["norm"])
        for k, v in t0["grads"].items():
            assert np.array_equal(t["grads"][k], v), k
        assert np.array_equal(r[ARCH][MESH]["serve"]["logits"], rec[MESH]["serve"]["logits"])


def test_the_pod_all_reduce_left_out_fails_the_gradient_bound(rec):
    """Without the sum over "pod" each pod keeps its half of the batch's
    gradient: every gradient is far off, and the norm too."""
    got, one = rec["plants"]["pod_dropped"], rec["one"]["train"]
    bad = [k for k in one["grads"] if P.far(got["grads"][k], one["grads"][k], 10)]
    assert len(bad) > len(one["grads"]) // 2
    assert abs(got["norm"] - one["norm"]) > 100 * P.TOL * one["norm"]


@pytest.mark.parametrize("mesh", sorted(MAPPED))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_arch_places_on_a_mesh_given_by_its_sizes(arch, mesh):
    """Nothing is refused at the published widths: every spec is the
    reference's, every rank-0 shard divides its leaf."""
    place = sharding.Placement(get_config(arch), MAPPED[mesh])
    assert place.batch == ("batch" if "pod" in MAPPED[mesh] else "data")
    for name, shape in place.shapes.items():
        local = place.local_shape(name)
        assert all(w % n == 0 for w, n in zip(shape, local)), name


def test_a_width_that_must_split_and_does_not_raises_naming_it():
    """MLA runs on a rank's heads: 4 heads do not split over 3 model ranks."""
    with pytest.raises(ValueError, match="4 MLA heads, 32 q latent columns do not split over 3 model ranks"):
        sharding.Placement(get_config("deepseek-v3-671b").reduced(), {"pod": 2, "data": 1, "model": 3})


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch):
    return jax.eval_shape(jax_build_model(jax_get_config(arch).reduced()).init, jax.random.PRNGKey(0))


def _flat(tree, is_leaf=None):
    return {jsh._path_str(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}


@pytest.mark.parametrize("mesh", sorted(POD_MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_batch_pspecs_on_a_pod_mesh_equal_the_references(arch, mesh):
    shape = POD_MESHES[mesh]
    names = ("pod", "data", "model")
    abstract = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    ref = _reference_shapes(arch)
    leaves = _flat(ref)
    want = _flat(jsh.param_pspecs(ref, abstract), lambda x: isinstance(x, PartitionSpec))
    got = sharding.param_pspecs(param_shapes(get_config(arch).reduced()), sizes)
    for name, spec in got.items():
        path, repeat, _ = reference_leaf(name)
        entries = tuple(want[path]) + (None,) * (len(leaves[path].shape) - len(tuple(want[path])))
        assert tuple(spec) == (entries if repeat is None else entries[1:]), name
    batch = {"tokens": np.zeros((8, 16), np.int32), "patches": np.zeros((8, 4, 32), np.float32),
             "length": np.zeros((), np.int32)}
    jwant = jsh.batch_pspecs({k: jnp.asarray(v) for k, v in batch.items()}, abstract)
    bgot = sharding.batch_pspecs(batch, sizes)
    for k in batch:
        assert tuple(bgot[k]) == tuple(jwant[k]), k
    assert tuple(bgot["tokens"]) == (("pod", "data"), None)
