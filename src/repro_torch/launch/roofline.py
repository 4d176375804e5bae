"""Roofline terms of a step on one H100 of a mesh of H100s, from what a
dry run counts (``launch/dryrun.py``: a walk over ``meta`` tensors, no
device). The counterpart of the reference's ``launch/roofline.py``.

Three terms per (arch × shape × mesh), all in seconds, for rank 0:

  compute     = FLOPs of the rank's step / peak FLOP/s
  memory      = bytes the rank's step reads and writes / HBM rate
  collective  = bytes the rank puts into each collective / its link's rate

The counts are the rank's own (the walk runs rank 0's shard shapes), so
nothing is divided by the number of cards. The reference parses the
collectives out of XLA's optimized HLO text; the port's step calls its
collectives itself, so their bytes come from the record of
``launch/collectives.py`` (``last_collectives()`` of a run on ranks, or
``ShapeComm.record`` of a walk): per "<op>/<group>", the calls and the
bytes the rank put in. A collective is charged its bytes once over its
group's link, as the reference charges one link (ROADMAP.md §3).

Hardware model: the published peaks of one NVIDIA H100 SXM5 80GB HBM3 at
its 700 W power limit, not measured here (one card cannot measure its
links): 3.35 TB/s of HBM3; 67 TFLOP/s of f32 on the CUDA cores, where the
port's ``blocked_matmul`` runs; 495 TFLOP/s of dense TF32 on the tensor
cores, a third of it for 3xTF32's f32-accurate products (the bound the
kernel table of PERF.md §6 holds the products to); NVLink 4 at 450 GB/s a
direction between the 8 cards of a node; one NDR InfiniBand port, 400
Gb/s = 50 GB/s, for a group that spans nodes. The ranks are numbered over
the mesh's axes ("pod", "data", "model"), the last fastest, and a node
holds 8 consecutive ranks: a group is within a node where the ranks it
spans are (``group_span``), whatever its size.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

#: the card the figures are published for
CARD = "NVIDIA H100 SXM5 80GB HBM3, 700 W"
#: HBM3, bytes/s
HBM_BW = 3.35e12
#: f32 on the CUDA cores, FLOP/s
PEAK_FLOPS_F32 = 67e12
#: 3xTF32 on the tensor cores (a third of dense TF32's 495 TFLOP/s), FLOP/s
PEAK_FLOPS_3XTF32 = 495e12 / 3
#: NVLink 4 between the cards of one node, one direction, bytes/s
NVLINK_BW = 450e9
#: one NDR InfiniBand port (400 Gb/s) between nodes, bytes/s
IB_BW = 50e9
#: cards a node joins by NVLink
NODE_CARDS = 8

#: the mesh's axes, outermost first: a rank's index runs fastest over the last
AXES = ("pod", "data", "model")
#: the mesh axes of each collective group of ``launch/collectives.py``
GROUP_AXES = {"model": ("model",), "data": ("data",), "pod": ("pod",), "batch": ("pod", "data")}


def hardware() -> Dict[str, Any]:
    """The figures the terms are computed at, with the card they are
    published for."""
    return {"card": CARD, "hbm_bytes_per_s": HBM_BW, "f32_flops_per_s": PEAK_FLOPS_F32,
            "3xtf32_flops_per_s": PEAK_FLOPS_3XTF32, "nvlink_bytes_per_s": NVLINK_BW,
            "infiniband_bytes_per_s": IB_BW, "node_cards": NODE_CARDS, "source": "published peaks"}


def group_size(kind: str, sizes: Mapping[str, int]) -> int:
    """The ranks of a language model placement's ``kind`` group ("model",
    "data", "pod", "batch") on a mesh of axis ``sizes``."""
    n = 1
    for a in GROUP_AXES[kind]:
        n *= int(sizes.get(a, 1))
    return n


def group_span(kind: str, sizes: Mapping[str, int]) -> int:
    """How many consecutive ranks a ``kind`` group's cards lie within on a
    mesh of axis ``sizes``: its size times the sizes of the axes inside
    its own (``AXES``). A "pod" group of 2 on 2 × 16 × 16 spans 512."""
    inner = AXES[AXES.index(GROUP_AXES[kind][-1]) + 1:]
    span = group_size(kind, sizes)
    for a in inner:
        span *= int(sizes.get(a, 1))
    return span


def link_rate(span: int) -> float:
    """The rate a group whose cards lie within ``span`` consecutive ranks
    is charged at: NVLink within a node, an InfiniBand port across nodes."""
    return NVLINK_BW if span <= NODE_CARDS else IB_BW


def collective_terms(record: Mapping[str, Mapping[str, int]], sizes: Mapping[str, int]) -> Dict[str, Any]:
    """The collective record's totals and its time: each "<op>/<group>"
    entry's bytes over its group's link."""
    by_kind: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    seconds = 0.0
    for key, rec in record.items():
        op, kind = key.split("/")
        by_kind[key] = int(rec["bytes"])
        counts[key] = int(rec["calls"])
        seconds += rec["bytes"] / link_rate(group_span(kind, sizes))
    return {"total_bytes": sum(by_kind.values()), "bytes_by_kind": by_kind, "counts": counts,
            "seconds": seconds}


def model_flops(arch: str, shape_name: str, cfg=None, shape=None) -> Optional[float]:
    """6·N·D (train) or 2·N·D (inference) with N = active params; ``cfg``
    (default ``get_config(arch)``) and ``shape`` (an ``InputShape``, default
    ``INPUT_SHAPES[shape_name]``) where the step ran others."""
    from repro_torch.configs import INPUT_SHAPES, get_config

    cfg = cfg if cfg is not None else get_config(arch)
    shp = shape if shape is not None else INPUT_SHAPES[shape_name]
    n_active = active_params(cfg)
    if shp.kind == "train":
        tokens = shp.global_batch * shp.seq_len
        return 6.0 * n_active * tokens
    if shp.kind == "prefill":
        tokens = shp.global_batch * shp.seq_len
        return 2.0 * n_active * tokens
    tokens = shp.global_batch * 1
    return 2.0 * n_active * tokens


def active_params(cfg) -> float:
    """Analytic active-parameter count (MoE: top-k routed + shared)."""
    d, v = cfg.d_model, cfg.vocab
    hd = cfg.hd() if cfg.n_heads else 0
    total = v * d  # embed
    if not cfg.tie_embeddings:
        total += d * v

    def attn_params():
        return d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d

    def mla_params():
        qh = cfg.nope_head_dim + cfg.rope_head_dim
        return (
            d * cfg.q_lora_rank
            + cfg.q_lora_rank * cfg.n_heads * qh
            + d * (cfg.kv_lora_rank + cfg.rope_head_dim)
            + cfg.kv_lora_rank * cfg.n_heads * (cfg.nope_head_dim + cfg.v_head_dim)
            + cfg.n_heads * cfg.v_head_dim * d
        )

    def mlp_params(ff):
        return 3 * d * ff

    def mamba1_params():
        c = cfg.ssm_expand * d
        dt_rank = max(1, d // 16)
        return d * 2 * c + 4 * c + c * (dt_rank + 2 * cfg.ssm_state) + dt_rank * c + c * d

    def mamba2_params():
        c = cfg.ssm_expand * d
        nh = c // cfg.ssm_head_dim
        return d * (2 * c + 2 * cfg.ssm_state + nh) + 4 * (c + 2 * cfg.ssm_state) + c * d

    from repro_torch.models.model import stages_of

    for st in stages_of(cfg):
        kinds = list(st.pattern) * st.repeats + list(st.tail)
        for kind in kinds:
            if kind in ("attn", "local", "global"):
                total += attn_params() + mlp_params(cfg.d_ff)
            elif kind == "moe":
                ff = cfg.d_expert_ff or cfg.d_ff
                total += attn_params() + cfg.top_k * 3 * d * ff
                total += cfg.n_shared_experts * 3 * d * ff
            elif kind == "mla":
                total += mla_params() + mlp_params(cfg.d_ff)
            elif kind == "mla_moe":
                ff = cfg.d_expert_ff or cfg.d_ff
                total += mla_params() + cfg.top_k * 3 * d * ff
                total += cfg.n_shared_experts * 3 * d * ff
            elif kind == "mamba1":
                total += mamba1_params()
            elif kind in ("mamba2", "mamba2_attn"):
                total += mamba2_params()
                if kind == "mamba2_attn":
                    total += attn_params() + mlp_params(cfg.d_ff)
            elif kind == "dec":
                total += 2 * attn_params() + mlp_params(cfg.d_ff)
            elif kind == "enc":
                total += attn_params() + mlp_params(cfg.d_ff)
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (attn_params() + mlp_params(cfg.d_ff))
    return float(total)


def roofline(flops: float, bytes_accessed: float, collectives: Mapping[str, Mapping[str, int]],
             sizes: Mapping[str, int], *, arch: str, shape: str, cfg=None,
             input_shape=None) -> Dict[str, Any]:
    """The three terms of a rank's step (module docstring) from its FLOPs,
    the bytes its operations read and write and its collective record on
    a mesh of axis ``sizes``, with ``dominant`` the largest and
    ``useful_flops_ratio`` the model's FLOPs per card over the counted
    ones (the reference's ``roofline_from_compiled``). The compute term is
    taken at 3xTF32's peak, ``compute_f32_s`` at the CUDA cores'."""
    coll = collective_terms(collectives, sizes)
    chips = 1
    for n in sizes.values():
        chips *= int(n)
    terms = {
        "compute_s": flops / PEAK_FLOPS_3XTF32,
        "memory_s": bytes_accessed / HBM_BW,
        "collective_s": coll["seconds"],
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(arch, shape, cfg, input_shape)
    mf_per_device = mf / chips if mf else None
    return {
        **terms,
        "dominant": dominant,
        "compute_f32_s": flops / PEAK_FLOPS_F32,
        "flops_per_device": flops,
        "bytes_per_device": bytes_accessed,
        "collective": coll,
        "model_flops_per_device": mf_per_device,
        "useful_flops_ratio": (mf_per_device / flops) if (mf_per_device and flops) else None,
        "chips": chips,
        "hardware": hardware(),
    }
