"""Model assembly: config → staged decoder, as an ``nn.Module``.

Layers are grouped into *stages*; each stage is a repeating superblock
(cfg.pattern) run ``repeats`` times, then its remainder layers
(n_layers % len(pattern)). The reference stacks each superblock's
parameters on a leading axis and runs them with ``jax.lax.scan``; here each
repeat is its own module in a ``ModuleList`` walked in Python, since
PyTorch runs eagerly and has no compile time to save. The reference's
sharding hints (``hint(x, DP, ...)``) mean nothing on one device and are
dropped; the multi-GPU slice brings them back as placements.

Parameters are made directly on the target device from an explicit
``torch.Generator`` there: a full-width model (29 GB in f32 for
falcon-mamba-7b) is never built on the host first. ``build_model`` runs on
"cuda" unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from repro_torch.core.session import resolve_device
from repro_torch.relational import rel_embed, rel_linear

from .blocks import block_apply, block_init
from .common import dense_init, embed_init, rms_norm, softcap


#: config fields of the reference's other families; a config that sets one
#: needs a module this slice does not port
_UNPORTED = ("encoder_layers", "vis_seq", "first_k_dense", "mla", "tie_embeddings", "embed_scale")


@dataclass(frozen=True)
class Stage:
    pattern: Tuple[str, ...]
    repeats: int
    tail: Tuple[str, ...] = ()


def stages_of(cfg) -> List[Stage]:
    """One stage: ``cfg.pattern`` repeated, then the remainder layers. The
    reference's leading dense stage (``first_k_dense``, deepseek-v3) waits
    for the MoE slice."""
    pat = cfg.pattern
    reps = cfg.n_layers // len(pat)
    tail = pat[: cfg.n_layers % len(pat)]
    return [Stage(pat, reps, tail)]


class Model(nn.Module):
    """The model's parameters, and ``train_logits`` / ``prefill`` /
    ``decode_step`` over them.

    ``stages[si]["scan"][r][f"{i}:{kind}"]`` is block ``i`` of repeat ``r``
    of stage ``si`` (the reference's ``params["stages"][si]["scan"]`` with
    its leading repeat axis unstacked); ``stages[si]["tail"][i]`` a
    remainder layer. Caches have the same layout: a list per stage of
    ``{"scan": [entry per repeat], "tail": [entry per layer]}``."""

    def __init__(self, cfg, device=None, seed: int = 0):
        super().__init__()
        unported = [f for f in _UNPORTED if getattr(cfg, f)]
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unported)} not ported yet "
                "(ROADMAP.md, queue 1, item 8: the LM zoo)"
            )
        dev = resolve_device(device, owner="repro_torch.models.Model")
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.stage_specs = stages_of(cfg)
        self.embed = nn.Parameter(embed_init(gen, (cfg.vocab, cfg.d_model), dtype=dt))
        self.ln_f = nn.Parameter(torch.zeros((cfg.d_model,), dtype=dt, device=dev))
        self.out_embed = nn.Parameter(dense_init(gen, (cfg.d_model, cfg.vocab), dtype=dt))
        self.stages = nn.ModuleList(
            nn.ModuleDict({
                "scan": nn.ModuleList(
                    nn.ModuleDict({
                        f"{i}:{kind}": block_init(gen, kind, cfg)
                        for i, kind in enumerate(st.pattern)
                    })
                    for _ in range(st.repeats)
                ),
                "tail": nn.ModuleList(block_init(gen, kind, cfg) for kind in st.tail),
            })
            for st in self.stage_specs
        )

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- embedding / head ---------------------------------------------------

    def _embed(self, tokens):
        return rel_embed(self.embed, tokens.reshape(-1)).reshape(*tokens.shape, self.cfg.d_model)

    def _head(self, x):
        h = rms_norm(x, self.ln_f, self.cfg.norm_eps)
        return softcap(rel_linear(h, self.out_embed).float(), self.cfg.final_softcap)

    # -- backbone -----------------------------------------------------------

    def _run_stages(self, x, ctx, caches):
        """caches: None (train, prefill) or the list of stage caches.
        Returns (x, new_caches)."""
        new_caches = []

        def run(block, kind, x, cache):
            return block_apply(block, kind, x, dict(ctx, cache=cache))

        for si, (st, stage) in enumerate(zip(self.stage_specs, self.stages)):
            scan_cache = []
            for r, sblock in enumerate(stage["scan"]):
                entry = caches[si]["scan"][r] if caches is not None else None
                new_entry = {}
                for i, kind in enumerate(st.pattern):
                    key = f"{i}:{kind}"
                    x, new_entry[key] = run(
                        sblock[key], kind, x, entry[key] if entry is not None else None
                    )
                scan_cache.append(new_entry)
            tail_cache = []
            for i, kind in enumerate(st.tail):
                x, c = run(
                    stage["tail"][i], kind, x,
                    caches[si]["tail"][i] if caches is not None else None,
                )
                tail_cache.append(c)
            new_caches.append({"scan": scan_cache, "tail": tail_cache})
        return x, new_caches

    # -- entry points --------------------------------------------------------

    def train_logits(self, batch: Dict[str, Any]):
        """batch: tokens (B,S). Returns (logits (B,S,V), aux), aux the
        reference's auxiliary loss, 0 for every ported block kind. Runs
        without rematerialization: LM training waits for a later slice."""
        x = self._embed(batch["tokens"])
        ctx = {"cfg": self.cfg, "mode": "train", "cache": None}
        x, _ = self._run_stages(x, ctx, None)
        return self._head(x), torch.zeros((), dtype=torch.float32, device=x.device)

    def prefill(self, batch: Dict[str, Any], cache_len: int):
        """Logits of the last position (B,1,V) and the caches after the
        prompt. ``cache_len`` sizes attention caches; the SSM state is O(1)."""
        x = self._embed(batch["tokens"])
        ctx = {"cfg": self.cfg, "mode": "prefill", "cache": None, "cache_len": cache_len}
        x, caches = self._run_stages(x, ctx, None)
        return self._head(x[:, -1:]), caches

    def decode_step(self, token, caches, length):
        """token: (B, 1) integer; caches from prefill (or the previous
        step); length: count of valid cache entries."""
        x = self._embed(token)
        ctx = {"cfg": self.cfg, "mode": "decode", "length": length}
        x, caches = self._run_stages(x, ctx, caches)
        return self._head(x), caches


def build_model(cfg, device=None, seed: int = 0) -> Model:
    """The model of ``cfg`` with random weights from ``seed``, made on
    ``device`` ("cuda" unless the caller passes another)."""
    return Model(cfg, device=device, seed=seed)
