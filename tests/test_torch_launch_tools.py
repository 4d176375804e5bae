"""``launch/roofline.py`` and ``launch/dryrun.py`` of the port against the
reference's: ``active_params`` and ``model_flops`` formula for formula on
every arch and shape; ``dryrun --all`` on the reduced configs (every
combination walked or skipped with the reference's reason, none an
error); one full-size combination, whose parameter bytes are rank 0's
shards of ``param_shapes`` (``Placement.local_shape``); and the walk's
collective record (``ShapeComm``) against what 4 ``gloo`` ranks on the CPU
record (``last_collectives()``) for the same steps of the reduced olmoe,
on a 2 × 2 × 1 pod mesh and a 1 × 4 mesh.

The reference's dry-run module sets XLA's host device count when it is
imported, so its ``SKIPS`` are read from its source instead.
"""

import ast
import json
import math
import pathlib

import pytest

import torch_lm_mesh_zoo_workers as Z
from repro.launch import roofline as jax_roofline
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import start_ranks
from repro_torch.launch.sharding import Placement
from repro_torch.models import build_model
from repro_torch.models.model import param_shapes

REFERENCE_DRYRUN = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro" / "launch" / "dryrun.py"


def _reference_skips():
    tree = ast.parse(REFERENCE_DRYRUN.read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "SKIPS" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("the reference's dryrun.py has no SKIPS")


@pytest.fixture(scope="module")
def ranks():
    """What 4 gloo ranks record, and what the walk records for rank 0."""
    return start_ranks(Z.dryrun_checks, 4, backend="gloo", device="cpu", args=("pod",))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_equal_the_references(arch):
    from repro.configs import get_config as jax_get_config

    assert roofline.active_params(get_config(arch)) == jax_roofline.active_params(jax_get_config(arch))
    for shape in INPUT_SHAPES:
        assert roofline.model_flops(arch, shape) == jax_roofline.model_flops(arch, shape)


def test_skips_are_the_references():
    assert dryrun.SKIPS == _reference_skips()


def test_dryrun_all_walks_every_reduced_combination(tmp_path):
    """``--all --reduced``: each (arch × shape × pod) is walked, or skipped
    with the reference's reason; none is an error, nothing is launched."""
    dryrun.main(["--all", "--reduced", "--out", str(tmp_path)])
    skips = _reference_skips()
    seen = 0
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            for pod in (1, 2):
                rec = json.loads((tmp_path / f"{arch}_{shape}_pod{pod}.json").read_text())
                seen += 1
                if (arch, shape) in skips:
                    assert rec["status"] == "skipped" and rec["reason"] == skips[arch, shape]
                    continue
                assert rec["status"] == "ok", rec.get("error")
                roof = rec["roofline"]
                assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
                assert roof["dominant"] in ("compute_s", "memory_s", "collective_s")
                assert roof["chips"] == (8 if pod == 2 else 4)
                assert "pod" in rec["mesh"] if pod == 2 else "pod" not in rec["mesh"]
                if pod == 2 and INPUT_SHAPES[shape].kind == "train":
                    assert rec["collectives"]["all_reduce/pod"]["calls"] > 0
    assert seen == len(ARCH_IDS) * len(INPUT_SHAPES) * 2
    table = dryrun.summary(str(tmp_path)).splitlines()
    assert len(table) == 2 + 2 * len(ARCH_IDS) and table[-1].endswith("| skipped |")


def test_a_full_size_combination_holds_rank_0s_shards():
    """olmoe-1b-7b's decode_32k on the 16 × 16 production mesh: the
    parameter bytes are ``param_shapes`` cut by ``Placement.local_shape``,
    the caches rank 0's 8 of 128 rows, and the terms are the counts over
    the H100's published figures."""
    rec = dryrun.dryrun_one("olmoe-1b-7b", "decode_32k", verbose=False)
    cfg = get_config("olmoe-1b-7b")
    place = Placement(cfg, dryrun.PRODUCTION)
    size = {n: p.element_size() for n, p in build_model(cfg, device="meta").named_parameters()}
    want = sum(math.prod(place.local_shape(n)) * size[n] for n in param_shapes(cfg))
    assert rec["status"] == "ok"
    assert rec["param_bytes"] == rec["argument_bytes"]["params"] == want
    assert rec["batch_fold"] == 16 and rec["argument_bytes"]["batch"] == 8 * 4
    roof = rec["roofline"]
    assert roof["memory_s"] == rec["bytes_accessed"] / roofline.HBM_BW
    assert roof["compute_s"] == rec["flops"] / roofline.PEAK_FLOPS_3XTF32
    assert roof["hardware"]["card"].startswith("NVIDIA H100")
    assert roof["model_flops_per_device"] == roofline.model_flops("olmoe-1b-7b", "decode_32k") / 256


@pytest.mark.parametrize("kind, sizes, span, rate", [
    ("pod", {"pod": 2, "data": 16, "model": 16}, 512, "IB_BW"),
    ("model", {"pod": 2, "data": 16, "model": 16}, 16, "IB_BW"),
    ("model", {"pod": 2, "data": 16, "model": 4}, 4, "NVLINK_BW"),
    ("data", {"data": 2, "model": 4}, 8, "NVLINK_BW"),
    ("data", {"data": 2, "model": 8}, 16, "IB_BW"),
    ("batch", {"pod": 2, "data": 2, "model": 1}, 4, "NVLINK_BW"),
    ("batch", {"pod": 2, "data": 16, "model": 4}, 128, "IB_BW"),
])
def test_link_rates_follow_the_ranks_a_group_spans(kind, sizes, span, rate):
    """A group is charged NVLink only where the consecutive ranks its
    cards lie within fit one 8-card node: a pod group of 2 on 2 × 16 × 16
    spans 512 ranks, another node's, and is charged InfiniBand."""
    assert roofline.group_span(kind, sizes) == span
    assert roofline.link_rate(roofline.group_span(kind, sizes)) == getattr(roofline, rate)
    terms = roofline.collective_terms({f"all_reduce/{kind}": {"calls": 2, "bytes": 900}}, sizes)
    assert terms["seconds"] == 900 / getattr(roofline, rate)
    assert terms["total_bytes"] == 900 and terms["counts"] == {f"all_reduce/{kind}": 2}


@pytest.mark.parametrize("mesh", ("2x2x1", "1x4"))
@pytest.mark.parametrize("step", ("train", "prefill", "decode"))
def test_the_walks_collectives_are_what_rank_0_records(ranks, mesh, step):
    rec = ranks[0][mesh]
    assert rec["measured"][step] == rec["walked"][step]
    assert rec["measured"][step]


@pytest.mark.parametrize("mesh", ("2x2x1", "1x4"))
def test_the_walks_parameter_bytes_are_rank_0s(ranks, mesh):
    rec = ranks[0][mesh]
    assert rec["param_bytes"] == rec["walked_param_bytes"]
