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

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import session
from repro_torch.core.remat import ProductStore
from repro_torch.core.session import resolve_device
from repro_torch.relational import rel_embed, rel_linear

from .blocks import block_apply, block_init, shared_attn_init
from .common import dense_init, embed_init, rms_norm, softcap


#: config fields of the reference's other families; a config that sets one
#: needs a module this slice does not port
_UNPORTED = ("encoder_layers", "vis_seq", "mrope_sections", "first_k_dense", "mla",
             "tie_embeddings", "embed_scale")


@dataclass(frozen=True)
class Stage:
    pattern: Tuple[str, ...]
    repeats: int
    tail: Tuple[str, ...] = ()


def stages_of(cfg) -> List[Stage]:
    """One stage: ``cfg.pattern`` repeated, then the remainder layers. The
    reference's leading dense stage (``first_k_dense``, deepseek-v3) waits
    for that model's slice."""
    pat = cfg.pattern
    reps = cfg.n_layers // len(pat)
    tail = pat[: cfg.n_layers % len(pat)]
    return [Stage(pat, reps, tail)]


def _all_kinds(stages: List[Stage]) -> set:
    out = set()
    for st in stages:
        out |= set(st.pattern) | set(st.tail)
    return out


def param_tree(flat: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """A name → tensor dict (``Model.named_parameters()``'s names) as the
    nested tree the model walks: dicts, with lists where every key is an
    index (``stages``, ``scan``, ``tail``)."""
    root: Dict[str, Any] = {}
    for name, t in flat.items():
        node = root
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        out = {k: lists(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    return lists(root)


class Model(nn.Module):
    """The model's parameters, and ``train_logits`` / ``prefill`` /
    ``decode_step`` over them.

    ``stages[si]["scan"][r][f"{i}:{kind}"]`` is block ``i`` of repeat ``r``
    of stage ``si`` (the reference's ``params["stages"][si]["scan"]`` with
    its leading repeat axis unstacked); ``stages[si]["tail"][i]`` a
    remainder layer; ``shared_attn`` zamba2's shared attention+MLP block,
    present when a stage has a ``mamba2_attn`` layer. Caches have the same
    layout: a list per stage of ``{"scan": [entry per repeat], "tail":
    [entry per layer]}``.

    ``train_logits``, ``prefill`` and ``decode_step`` run on the module's
    own parameters, or on ``params``: a name → tensor dict with
    ``named_parameters()``'s names (the trainer's functional form, the
    reference's ``(params, batch)``; the serving front door passes a
    registered version's, so that one module serves versions with
    parameters of their own)."""

    def __init__(self, cfg, device=None, seed: int = 0):
        super().__init__()
        unported = [f for f in _UNPORTED if getattr(cfg, f)]
        if unported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unported)} not ported yet "
                "(ROADMAP.md, queue 1, item 6.4: the LM zoo)"
            )
        dev = resolve_device(device, owner="repro_torch.models.Model")
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.stage_specs = stages_of(cfg)
        self.embed = nn.Parameter(embed_init(gen, (cfg.vocab, cfg.d_model), dtype=dt))
        self.ln_f = nn.Parameter(torch.zeros((cfg.d_model,), dtype=dt, device=dev))
        self.out_embed = nn.Parameter(dense_init(gen, (cfg.d_model, cfg.vocab), dtype=dt))
        self.has_shared = "mamba2_attn" in _all_kinds(self.stage_specs)
        if self.has_shared:
            self.shared_attn = shared_attn_init(gen, cfg)
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

    def _tree(self, params):
        """What the entry points walk: the module itself, or ``params``
        as a tree (``param_tree``)."""
        return self if params is None else param_tree(params)

    def __getitem__(self, name: str):
        return getattr(self, name)

    # -- embedding / head ---------------------------------------------------

    def _embed(self, p, tokens):
        return rel_embed(p["embed"], tokens.reshape(-1)).reshape(*tokens.shape, self.cfg.d_model)

    def _head(self, p, x):
        h = rms_norm(x, p["ln_f"], self.cfg.norm_eps)
        return softcap(rel_linear(h, p["out_embed"]).float(), self.cfg.final_softcap)

    # -- backbone -----------------------------------------------------------

    def _run_stages(self, p, x, ctx, caches):
        """caches: None (train, prefill) or the list of stage caches.
        Returns (x, new_caches, aux): aux the blocks' auxiliary losses,
        summed.

        With ``cfg.remat`` in train mode, when autograd records, each
        superblock runs under ``torch.utils.checkpoint`` (the reference's
        ``jax.checkpoint``): only its input is kept, and the backward runs
        its forward again, in the session that ran it the first time
        (autograd may run the backward on a thread of its own, which does
        not see the caller's ``Database.activate``). With
        ``remat_policy="dots"`` (the reference's ``dots_saveable``) the
        outputs of the superblock's products (each ``rel_linear``, each
        ``common.einsum``) are kept from the first run and handed back in
        call order at the recompute (``core/remat.py``), so the recompute
        launches no product; with "nothing" (any other policy, as in the
        reference) they are computed again."""
        cfg = self.cfg
        remat = cfg.remat and ctx["mode"] == "train" and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = []

        def superblock(pattern, sblock, x, entry):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            new_entry = {}
            for i, kind in enumerate(pattern):
                key = f"{i}:{kind}"
                x, new_entry[key], a = block_apply(
                    sblock[key], kind, x,
                    dict(ctx, cache=entry[key] if entry is not None else None),
                )
                aux = aux + a
            return x, new_entry, aux

        def rematted(pattern, sblock, x):
            db = session.current()

            def run(x):
                x, _, aux = superblock(pattern, sblock, x, None)
                return x, aux

            def contexts():
                if cfg.remat_policy != "dots":
                    return contextlib.nullcontext(), db.activate()
                store = ProductStore()

                @contextlib.contextmanager
                def recompute():
                    with db.activate(), store.replay():
                        yield

                return store.record(), recompute()

            return checkpoint(run, x, use_reentrant=False, context_fn=contexts)

        for si, st in enumerate(self.stage_specs):
            stage = p["stages"][si]
            scan_cache = []
            for r, sblock in enumerate(stage["scan"]):
                if remat:
                    x, a = rematted(st.pattern, sblock, x)
                    new_entry = {f"{i}:{kind}": {} for i, kind in enumerate(st.pattern)}
                else:
                    entry = caches[si]["scan"][r] if caches is not None else None
                    x, new_entry, a = superblock(st.pattern, sblock, x, entry)
                aux_total = aux_total + a
                scan_cache.append(new_entry)
            tail_cache = []
            for i, kind in enumerate(st.tail):
                x, c, a = block_apply(
                    stage["tail"][i], kind, x,
                    dict(ctx, cache=caches[si]["tail"][i] if caches is not None else None),
                )
                aux_total = aux_total + a
                tail_cache.append(c)
            new_caches.append({"scan": scan_cache, "tail": tail_cache})
        return x, new_caches, aux_total

    def _positions(self, b: int, s: int, length=None):
        """(B, S) positions 0..S-1, or (B, 1) at ``length`` in decode (the
        reference's M-RoPE branch waits for qwen2-vl)."""
        if length is not None:
            return torch.full((b, 1), int(length), dtype=torch.int32, device=self.device)
        return torch.arange(s, dtype=torch.int32, device=self.device)[None].expand(b, s)

    def _share(self, p, ctx) -> None:
        """zamba2's shared block as ``ctx["shared"]``, for every
        ``mamba2_attn`` layer."""
        if self.has_shared:
            ctx["shared"] = p["shared_attn"]

    # -- entry points --------------------------------------------------------

    def train_logits(self, batch: Dict[str, Any], params: Optional[Mapping[str, torch.Tensor]] = None):
        """batch: tokens (B,S). Returns (logits (B,S,V) f32, aux), aux the
        blocks' auxiliary losses summed (the MoE's load-balance loss; 0
        for the other kinds)."""
        p = self._tree(params)
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(p, tokens)
        ctx = {"cfg": self.cfg, "mode": "train", "positions": self._positions(b, s), "cache": None}
        self._share(p, ctx)
        x, _, aux = self._run_stages(p, x, ctx, None)
        return self._head(p, x), aux

    def prefill(self, batch: Dict[str, Any], cache_len: int,
                params: Optional[Mapping[str, torch.Tensor]] = None):
        """Logits of the last position (B,1,V) and the caches after the
        prompt. ``cache_len`` sizes attention caches (the prompt's K/V
        padded to it); the SSM state is O(1)."""
        p = self._tree(params)
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(p, tokens)
        ctx = {"cfg": self.cfg, "mode": "prefill", "positions": self._positions(b, s),
               "cache": None, "cache_len": cache_len}
        self._share(p, ctx)
        x, caches, _ = self._run_stages(p, x, ctx, None)
        return self._head(p, x[:, -1:]), caches

    def decode_step(self, token, caches, length, params: Optional[Mapping[str, torch.Tensor]] = None):
        """token: (B, 1) integer; caches from prefill (or the previous
        step); length: count of valid cache entries (an int)."""
        p = self._tree(params)
        x = self._embed(p, token)
        ctx = {"cfg": self.cfg, "mode": "decode",
               "positions": self._positions(token.shape[0], 1, length=length), "length": length}
        self._share(p, ctx)
        x, caches, _ = self._run_stages(p, x, ctx, caches)
        return self._head(p, x), caches


def build_model(cfg, device=None, seed: int = 0) -> Model:
    """The model of ``cfg`` with random weights from ``seed``, made on
    ``device`` ("cuda" unless the caller passes another)."""
    return Model(cfg, device=device, seed=seed)
