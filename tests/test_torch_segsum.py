"""segment_sum's summation order, its launch plan and its work split, on
the CPU.

The CUDA kernel (src/repro_torch/kernels/csrc/segsum.cu) runs only on the
card, where tests/test_torch_cuda.py and chip_smoke.py hold its bits to
``ref.segment_sum_in_kernel_order``. Here: that order, written out in
PyTorch, against the JAX package's segment sum (its Pallas kernel in
interpret mode, as the JAX package's own tests run it) at atol 1e-5 in f32
and within one rounding of the working type in bf16 and f16; against the
plain version bit for bit where no segment passes one chunk; the wrapper's
pure-Python plan at every shape chip_smoke.py uses; and the sorted path's
split into chunks, emulated in numpy f32 from the kernel's own index rules,
against the order's bits.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.segsum.ops import segment_sum as jax_segment_sum
from repro.kernels.segsum.ref import segment_sum_ref as jax_segment_sum_ref
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.data import synthetic_graph
from repro_torch.kernels import segment_sum
from repro_torch.kernels.segsum import ops
from repro_torch.kernels.segsum.ref import CHUNK, segment_sum_in_kernel_order, segment_sum_ref

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-5
#: unit roundoff of the working types
UNIT = {torch.float32: 2.0 ** -24, torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CHIP_SMOKE = _chip_smoke()


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launch_counts()
    yield
    assert sum(kernels.launch_counts().values()) == 0, "no CUDA kernel may launch for CPU tensors"


def _ids(kind, rng):
    """(segment ids, S) of one case."""
    if kind == "padding":  # -1 and ids >= S among random ids
        seg = rng.integers(0, 40, size=300)
        seg[[0, 7, 99]] = [-1, 40, 57]
        return seg, 40
    if kind == "empty segments":  # only even ids: half the segments empty
        return 2 * rng.integers(0, 30, size=200), 61
    if kind == "long segment":  # 600 terms into segment 3, past two chunks
        seg = rng.integers(0, 20, size=900)
        seg[rng.permutation(900)[:600]] = 3
        return seg, 20
    if kind == "gcn skew":  # the GCN's Pareto-skewed destinations
        g = synthetic_graph(300, 2_000, 4, 3, seed=1)
        return g["edge_keys"][:, 1], 300
    if kind == "E=0":
        return np.zeros(0, np.int64), 9
    if kind == "S=0":
        return rng.integers(-3, 3, size=12), 0
    raise ValueError(kind)


def _messages(rng, seg, s, d):
    """Messages as a normalised GCN sends them: N(0, 1) features scaled by
    1/√(terms of their segment), so that every sum is of order 1."""
    valid = (seg >= 0) & (seg < s)
    terms = np.bincount(seg[valid], minlength=max(s, 1))
    scale = np.ones(seg.shape[0])
    scale[valid] = 1.0 / np.sqrt(terms[seg[valid]])
    return (rng.normal(size=(seg.shape[0], d)) * scale[:, None]).astype(np.float32)


def _jax_segment_sum(msg, seg, s):
    if msg.shape[0] == 0 or s == 0:
        # the Pallas kernel takes no empty edge list or segment range (the
        # compiler's zero-nnz guard never sends one): its plain version
        # stands in
        return jax_segment_sum_ref(msg, jnp.asarray(seg, jnp.int32), s)
    return jax_segment_sum(msg, jnp.asarray(seg, jnp.int32), s, interpret=True)


CASES = ["padding", "empty segments", "long segment", "gcn skew", "E=0", "S=0"]


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("d", [1, 8])
def test_kernel_order_matches_jax(kind, d):
    rng = np.random.default_rng(len(kind) * 10 + d)
    seg, s = _ids(kind, rng)
    msg = _messages(rng, seg, s, d)
    want = np.asarray(_jax_segment_sum(jnp.asarray(msg, jnp.float32), seg, s))
    got = segment_sum_in_kernel_order(torch.tensor(msg), torch.tensor(seg, dtype=torch.int32), s)
    assert got.shape == (s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("kind", ["padding", "long segment", "gcn skew"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_working_types_match_jax(kind, dtype):
    """bf16 and f16 in and out, the sum in f32 rounded once: the JAX
    kernel, the port's plain version (the wrapper on the CPU) and the
    kernel's order each round an f32 sum of the same terms once, so they
    agree within the f32 rounding plus one rounding of the working type
    each."""
    rng = np.random.default_rng(len(kind))
    seg, s = _ids(kind, rng)
    msg = torch.tensor(_messages(rng, seg, s, 8)).to(dtype)
    ids = torch.tensor(seg, dtype=torch.int32)
    want = np.asarray(
        _jax_segment_sum(jnp.asarray(msg.float().numpy()).astype(JNP[dtype]), seg, s)
    ).astype(np.float32)
    tol = 2 * UNIT[dtype] * np.abs(want) + ATOL
    for got in (segment_sum(msg, ids, s), segment_sum_in_kernel_order(msg, ids, s)):
        assert got.dtype == dtype
        assert np.all(np.abs(got.float().numpy() - want) <= tol)


@pytest.mark.parametrize("kind", ["padding", "empty segments", "gcn skew"])
def test_kernel_order_equals_plain_version_within_one_chunk(kind):
    """Where no segment has more than CHUNK terms, the order is index_add_'s
    on the CPU (ascending edges, one add each): the same bits."""
    rng = np.random.default_rng(3)
    seg, s = _ids(kind, rng)
    assert np.bincount(seg[(seg >= 0) & (seg < s)], minlength=s).max() <= CHUNK
    msg = torch.tensor(_messages(rng, seg, s, 16))
    ids = torch.tensor(seg, dtype=torch.int32)
    assert torch.equal(segment_sum_in_kernel_order(msg, ids, s), segment_sum_ref(msg, ids, s))


def test_kernel_order_sums_chunks_then_adds_them_in_order():
    """One segment of 600 terms: chunks [0, 256), [256, 512), [512, 600),
    each summed from 0 in f32, then added from 0 in order."""
    rng = np.random.default_rng(5)
    msg = rng.normal(size=(600, 3)).astype(np.float32) * np.float32(1e3)
    msg[::7] *= np.float32(1e-6)  # magnitudes far apart: the order shows in the bits
    seg = np.zeros(600, np.int32)
    total = np.zeros(3, np.float32)
    for a in range(0, 600, CHUNK):
        part = np.zeros(3, np.float32)
        for row in msg[a:a + CHUNK]:
            part = part + row
        total = total + part
    got = segment_sum_in_kernel_order(torch.tensor(msg), torch.tensor(seg), 1)
    assert np.array_equal(got.numpy()[0], total)


def test_kernel_order_keeps_its_bits_whatever_else_is_summed():
    """A segment's bits depend on its own terms alone: more segments, more
    edges elsewhere, or padding ids in between leave them as they are."""
    rng = np.random.default_rng(6)
    seg, s = _ids("long segment", rng)
    msg = torch.tensor(_messages(rng, seg, s, 4))
    ids = torch.tensor(seg, dtype=torch.int32)
    alone = segment_sum_in_kernel_order(msg, ids, s)
    # 50 edges of other segments and padding ids, put in between at random
    n = seg.shape[0] + 50
    extra = np.zeros(n, bool)
    extra[rng.permutation(n)[:50]] = True
    more = torch.empty(n, 4)
    more[torch.tensor(~extra)] = msg
    more[torch.tensor(extra)] = torch.tensor(rng.normal(size=(50, 4)).astype(np.float32))
    others = rng.integers(s, 3 * s + 5, size=50)
    others[::9] = -1
    more_ids = torch.empty(n, dtype=torch.int32)
    more_ids[torch.tensor(~extra)] = ids
    more_ids[torch.tensor(extra)] = torch.tensor(others, dtype=torch.int32)
    both = segment_sum_in_kernel_order(more, more_ids, 3 * s + 5)
    assert torch.equal(both[:s], alone)


def test_wrapper_matches_jax_forward_and_backward():
    rng = np.random.default_rng(8)
    seg, s = _ids("long segment", rng)
    msg = _messages(rng, seg, s, 5)
    cot = rng.normal(size=(s, 5)).astype(np.float32)

    def jax_loss(m):
        out = _jax_segment_sum(m, seg, s)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, want), jgrad = jax.value_and_grad(jax_loss, has_aux=True)(jnp.asarray(msg, jnp.float32))
    tm = torch.tensor(msg, requires_grad=True)
    got = segment_sum(tm, torch.tensor(seg, dtype=torch.int32), s)
    got.backward(torch.tensor(cot))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgrad), atol=ATOL)


# ---------------------------------------------------------------------------
# The plan, and the sorted path's split into chunks
# ---------------------------------------------------------------------------


SHAPES = sorted({(e, d, s) for e, d, s, _ in CHIP_SMOKE.segsum_shapes(get_config(CHIP_SMOKE.LM_ARCH))})


@pytest.mark.parametrize("e,d,s", SHAPES, ids=str)
@pytest.mark.parametrize("elem_bytes", [4, 2])
def test_plan_at_every_chip_smoke_shape(e, d, s, elem_bytes):
    p = ops.plan(e, d, s, elem_bytes)
    assert p.path == ("scan" if e <= ops.SCAN_MAX_EDGES else "sorted")
    assert p.unit in (1, 16 // elem_bytes) and d % p.unit == 0
    assert p.unit == (16 // elem_bytes if d % (16 // elem_bytes) == 0 else 1)
    width = d // p.unit
    blocks, slabs = p.grid
    # the column slabs cover each row's units once: a warp's 32 lanes take
    # per_lane units each, the slabs side by side
    assert slabs * 32 * p.per_lane >= width > (slabs - 1) * 32 * p.per_lane
    assert 1 <= slabs <= ops.GRID_Y_MAX
    if p.path == "scan":
        # a warp per output row
        assert blocks * ops.WARPS >= s > (blocks - 1) * ops.WARPS
        assert (p.tiles, p.combine_grid, p.workspace) == (0, (0, 0), 0)
    else:
        # a warp per segment (its chunk 0) and per tile (a chunk c >= 1)
        tiles = -(-e // CHUNK)
        assert p.tiles == tiles
        assert blocks * ops.WARPS >= s + tiles > (blocks - 1) * ops.WARPS
        assert p.combine_grid[0] * ops.WARPS >= tiles
        assert p.workspace == 2 * tiles * d
    assert p == ops.plan(e, d, s, elem_bytes)


def test_plan_picks_the_path_at_the_crossover():
    edge = ops.SCAN_MAX_EDGES
    assert ops.plan(edge, 4096, edge).path == "scan"
    assert ops.plan(edge + 1, 4096, edge + 1).path == "sorted"
    assert ops.plan(0, 4, 5).path == "scan"
    assert ops.plan(2, 4096, 2).path == "scan"
    # a misaligned pointer or a ragged row takes single elements
    assert ops.plan(100, 64, 10, 4, aligned=False).unit == 1
    assert ops.plan(100, 66, 10, 4).unit == 1
    assert ops.plan(100, 64, 10, 2).unit == 8


def test_plan_constants_are_the_kernels():
    src = (ROOT / "src/repro_torch/kernels/csrc/segsum.cu").read_text()
    assert re.search(r"constexpr int kChunk = (\d+);", src).group(1) == str(CHUNK)
    assert re.search(r"constexpr int kWarps = (\d+);", src).group(1) == str(ops.WARPS)
    assert "width >= 128 ? 4 : width >= 64 ? 2 : 1" in src
    # no atomics on the output: no atomicAdd, no PTX red
    assert "atomicAdd" not in src and not re.search(r"\bred\.", src)


def _tile_head(t, ids, starts, s_count):
    """csrc/segsum.cu tile_head: the chunk c >= 1 that begins in tile t."""
    p = t * CHUNK
    if p >= ids.shape[0]:
        return None
    s = int(ids[p])
    if s < 0 or s >= s_count:
        return None
    st, en = int(starts[s]), int(starts[s + 1])
    if st == p:
        return None
    c = (p - st + CHUNK - 1) // CHUNK
    at = st + c * CHUNK
    if at >= en or at >= p + CHUNK:
        return None
    return s, c, at, st, en


def _emulate_sorted_path(msg, seg, s_count):
    """The sorted path as the kernels split it, in numpy f32: returns the
    output and the (segment, chunk) each warp summed."""
    ids, perm = torch.sort(torch.tensor(seg, dtype=torch.int32), stable=True)
    ids, perm = ids.numpy(), perm.numpy()
    starts = np.searchsorted(ids, np.arange(s_count + 1), side="left")  # repro_segsum_starts
    e, d = msg.shape
    tiles = -(-e // CHUNK)
    ws = np.full((2 * tiles, d), np.nan, np.float32)
    out = np.full((s_count, d), np.nan, np.float32)
    done = []

    def run(a, b):
        acc = np.zeros(d, np.float32)
        for q in range(a, b):
            acc = acc + msg[perm[q]]
        return acc

    for w in range(s_count + tiles):  # segsum_chunk_kernel, a warp each
        if w < s_count:
            st, en = starts[w], starts[w + 1]
            acc = run(st, min(en, st + CHUNK))
            done.append((w, 0))
            if en - st <= CHUNK:
                assert np.isnan(out[w]).all()
                out[w] = np.float32(0) + acc
            else:
                assert np.isnan(ws[2 * (st // CHUNK) + 1]).all()
                ws[2 * (st // CHUNK) + 1] = acc
        else:
            head = _tile_head(w - s_count, ids, starts, s_count)
            if head:
                sg, c, at, _, en = head
                done.append((sg, c))
                assert np.isnan(ws[2 * (w - s_count)]).all()
                ws[2 * (w - s_count)] = run(at, min(en, at + CHUNK))
    for t in range(tiles):  # segsum_combine_kernel
        head = _tile_head(t, ids, starts, s_count)
        if head and head[1] == 1:
            sg, _, _, st, en = head
            total = np.zeros(d, np.float32)
            for c in range(-(-(en - st) // CHUNK)):
                at = st + c * CHUNK
                part = ws[2 * (at // CHUNK) + (1 if c == 0 else 0)]
                assert not np.isnan(part).any()
                total = total + part
            assert np.isnan(out[sg]).all()
            out[sg] = total
    return out, done


@pytest.mark.parametrize("kind", ["padding", "empty segments", "long segment", "gcn skew", "chunk edges"])
def test_sorted_path_split_covers_every_chunk_once(kind):
    """Every (segment, chunk) is summed by exactly one warp, every output
    row written exactly once, and the result has the order's bits."""
    rng = np.random.default_rng(11)
    if kind == "chunk edges":
        # segments of exactly 256, 257, 512 and 1 terms, and 1,000 padding ids
        seg = np.concatenate([np.full(n, i) for i, n in enumerate((256, 257, 512, 1, 513))] + [np.full(1000, -1)])
        seg = seg[rng.permutation(seg.shape[0])]
        s = 6
    else:
        seg, s = _ids(kind, rng)
    msg = _messages(rng, seg, s, 3)
    out, done = _emulate_sorted_path(msg, seg, s)
    valid = seg[(seg >= 0) & (seg < s)]
    counts = np.bincount(valid, minlength=s)
    want = {(i, c) for i in range(s) for c in range(max(1, -(-counts[i] // CHUNK)))}
    assert sorted(done) == sorted(want)
    assert not np.isnan(out).any()
    order = segment_sum_in_kernel_order(torch.tensor(msg), torch.tensor(seg, dtype=torch.int32), s)
    assert np.array_equal(out, order.numpy())
