"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's (``repro.launch.sharding``), leaf for leaf, with no ranks:
``param_pspecs`` of every arch at its full published shapes on the
(2, 2), (16, 16) and (2, 16, 16) geometries with FSDP on and off, and
``cache_pspecs``, ``batch_pspecs`` and ``coo_pspecs``.

The port side is built on the ``meta`` device (``param_shapes``,
``init_cache(device="meta")``), the reference's with ``jax.eval_shape``
and given a ``jax.sharding.AbstractMesh``; the port's rules take the axis
sizes as a mapping. A port leaf is one repeat of the reference's stacked
leaf (``convert.reference_leaf``): its spec must equal the reference's
with the leading entry dropped, and that entry must be None wherever the
reference treats the axis as a layer axis (its stage ``scan`` leaves).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

import repro.core.relation as jrel
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jsh
from repro.models import build_model as jax_build_model
from repro.serving.serve import init_cache as jax_init_cache
from repro_torch.configs import get_config
from repro_torch.convert import reference_leaf
from repro_torch.core.planner import MeshGeometry, P
from repro_torch.core.relation import CooRelation
from repro_torch.launch import sharding
from repro_torch.models.model import param_shapes
from repro_torch.serving import init_cache

#: the geometries: the host-sized 2 × 2, the production 16 × 16 and the
#: multi-pod 2 × 16 × 16
GEOMETRIES = {
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _abstract(geo):
    shape, names = GEOMETRIES[geo]
    return AbstractMesh(shape, names)


def _sizes(geo):
    shape, names = GEOMETRIES[geo]
    return dict(zip(names, shape))


def _is_spec(x):
    return isinstance(x, PartitionSpec)


def _flat(tree, is_leaf=None):
    return {jsh._path_str(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree, is_leaf=is_leaf)}


def _entries(spec, ndim):
    """A reference spec as a tuple of ``ndim`` entries (jax may drop the
    trailing Nones)."""
    out = tuple(spec)
    return out + (None,) * (ndim - len(out))


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch):
    return jax.eval_shape(jax_build_model(jax_get_config(arch)).init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_pspecs_equal_the_reference(arch, geo):
    shapes = _reference_shapes(arch)
    leaves = _flat(shapes)
    port_shapes = param_shapes(get_config(arch))
    assert len(port_shapes) >= len(leaves)
    for fsdp in (True, False):
        want = _flat(jsh.param_pspecs(shapes, _abstract(geo), fsdp=fsdp), _is_spec)
        got = sharding.param_pspecs(port_shapes, _sizes(geo), fsdp=fsdp)
        assert set(got) == set(port_shapes)
        for name, spec in got.items():
            path, repeat, stacked = reference_leaf(name)
            ref = _entries(want[path], len(leaves[path].shape))
            if repeat is not None:
                assert leaves[path].shape[1:] == port_shapes[name], name
                if stacked:
                    assert ref[0] is None, (name, ref)
                ref = ref[1:]
            else:
                assert leaves[path].shape == port_shapes[name], name
            assert tuple(spec) == ref, (name, fsdp, spec, ref)


def test_the_fsdp_threshold_counts_a_stages_repeats():
    """olmoe's router is 2,048 × 64 × 4 B = 512 KiB a layer, 8 MiB over its
    16 layers: FSDP'd on "data", as the reference's stacked leaf is."""
    specs = sharding.param_pspecs(param_shapes(get_config("olmoe-1b-7b")), {"data": 16, "model": 16})
    assert specs["stages.0.scan.3.0:moe.moe.router"] == P("data", None)
    assert specs["stages.0.scan.3.0:moe.moe.wi_gate"] == P("model", "data", None)
    assert specs["embed"] == P("model", "data")


def test_a_geometry_reads_like_its_axis_sizes():
    geo = MeshGeometry("model", 16, ("data",), 16)
    shapes = param_shapes(get_config("llama3-405b"))
    assert sharding.param_pspecs(shapes, geo) == sharding.param_pspecs(shapes, _sizes("16x16"))
    with pytest.raises(ValueError, match="mapping"):
        sharding.axis_sizes(MeshGeometry("model", 16, ("pod", "data"), 32))


def _port_cache_leaves(caches):
    """(stage, "scan"|"tail", repeat or index, key path, leaf) of a port
    cache tree."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out.append((path, node))

    for si, stage in enumerate(caches):
        for part in ("scan", "tail"):
            for i, entry in enumerate(stage[part]):
                walk(entry, (si, part, i))
    return out


@pytest.mark.parametrize("seq_sharded", (False, True))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_pspecs_equal_the_reference(arch, seq_sharded):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    batch = 1 if seq_sharded else 32
    cache_len = 4096
    jshapes = jax.eval_shape(lambda: jax_init_cache(jcfg, batch, cache_len))
    want = jsh.cache_pspecs(jshapes, _abstract("16x16"), batch=batch, seq_sharded=seq_sharded)
    port = init_cache(cfg, batch, cache_len, device="meta")
    got = sharding.cache_pspecs(port, _sizes("16x16"), batch=batch, seq_sharded=seq_sharded)
    leaves = _port_cache_leaves(port)
    assert leaves
    for (si, part, i, *keys), leaf in leaves:
        spec = got[si][part][i]
        ref, ref_shape = want[si][part], jshapes[si][part]
        for k in keys:
            spec = spec[k]
        if part == "tail":
            ref, ref_shape = ref[i], ref_shape[i]
        for k in keys:
            ref, ref_shape = ref[k], ref_shape[k]
        ref = _entries(ref, len(ref_shape.shape))
        if part == "scan":
            assert ref_shape.shape[1:] == tuple(leaf.shape) and ref[0] is None
            ref = ref[1:]
        assert tuple(spec) == ref, (si, part, i, keys, spec, ref)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_batch_pspecs_equal_the_reference(geo):
    batch = {"tokens": np.zeros((8, 16), np.int32), "labels": np.zeros((8, 16), np.int32),
             "frames": np.zeros((8, 4, 32), np.float32), "length": np.zeros((), np.int32)}
    want = jsh.batch_pspecs({k: jnp.asarray(v) for k, v in batch.items()}, _abstract(geo))
    got = sharding.batch_pspecs(batch, _sizes(geo))
    assert set(got) == set(want)
    for k, v in batch.items():
        assert tuple(got[k]) == _entries(want[k], v.ndim), k


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_coo_pspecs_equal_the_reference(geo):
    keys = np.zeros((12, 2), np.int32)
    values = np.zeros((12, 3), np.float32)
    jr = jrel.CooRelation(jnp.asarray(keys), jnp.asarray(values), (4, 4))
    want = jsh.coo_pspecs(jr, _abstract(geo))
    import torch

    got = sharding.coo_pspecs(CooRelation(torch.as_tensor(keys), torch.as_tensor(values), (4, 4)),
                              _sizes(geo))
    assert tuple(got.keys) == _entries(want.keys, 2)
    assert tuple(got.values) == _entries(want.values, 2)
    assert got.extents == tuple(want.extents)


def test_hint_is_a_no_op_off_a_mesh():
    import torch

    x = torch.ones(4, 3)
    assert sharding.hint(x, sharding.DP, None) is x
