"""Model assembly: config → staged decoder (+ optional encoder), as an
``nn.Module``.

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

The port builds every family of the reference: olmoe, falcon-mamba,
zamba2, gemma2/3 (tied embeddings, ``embed_scale``, the final softcap), the
llama-architecture configs, deepseek-v3 (MLA, and a leading dense stage of
``first_k_dense`` layers before the MoE stage), whisper (an encoder over
the stubbed frame embeddings, whose output every decoder layer
cross-attends to) and qwen2-vl (M-RoPE over t/h/w positions, and the
stubbed patch embeddings as a prefix of the sequence).
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
from .common import dense_init, einsum, embed_init, layer_norm, rms_norm, softcap


@dataclass(frozen=True)
class Stage:
    pattern: Tuple[str, ...]
    repeats: int
    tail: Tuple[str, ...] = ()


def stages_of(cfg) -> List[Stage]:
    """One stage: ``cfg.pattern`` repeated, then the remainder layers; with
    ``first_k_dense`` (deepseek-v3) two: that many dense-FFN layers, then
    the MoE layers."""
    if cfg.first_k_dense:
        return [
            Stage(("mla" if cfg.mla else "attn",), cfg.first_k_dense),
            Stage(("mla_moe" if cfg.mla else "moe",), cfg.n_layers - cfg.first_k_dense),
        ]
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
    present when a stage has a ``mamba2_attn`` layer; ``encoder[r]``
    whisper's encoder layer ``r`` (the reference's ``params["encoder"]``,
    stacked on a leading axis, unstacked), with ``enc_ln_s``/``enc_ln_b``
    its final LayerNorm. Caches have the same
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
        dev = resolve_device(device, owner="repro_torch.models.Model")
        gen = torch.Generator(device=dev).manual_seed(seed)
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.stage_specs = stages_of(cfg)
        self.embed = nn.Parameter(embed_init(gen, (cfg.vocab, cfg.d_model), dtype=dt))
        self.ln_f = nn.Parameter(torch.zeros((cfg.d_model,), dtype=dt, device=dev))
        if not cfg.tie_embeddings:
            self.out_embed = nn.Parameter(dense_init(gen, (cfg.d_model, cfg.vocab), dtype=dt))
        self.has_shared = "mamba2_attn" in _all_kinds(self.stage_specs)
        if self.has_shared:
            self.shared_attn = shared_attn_init(gen, cfg)
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(block_init(gen, "enc", cfg)
                                         for _ in range(cfg.encoder_layers))
            self.enc_ln_s = nn.Parameter(torch.ones((cfg.d_model,), dtype=dt, device=dev))
            self.enc_ln_b = nn.Parameter(torch.zeros((cfg.d_model,), dtype=dt, device=dev))
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
        cfg = self.cfg
        x = rel_embed(p["embed"], tokens.reshape(-1)).reshape(*tokens.shape, cfg.d_model)
        if cfg.embed_scale:
            # sqrt(d_model) rounded to the activations' dtype first, as the
            # reference's jnp.asarray(cfg.d_model**0.5, x.dtype)
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    def _head(self, p, x):
        """The logits, f32. A tied head (gemma) is the product with the
        embedding table through ``common.einsum``, as the reference's
        ``jnp.einsum`` outside every Pallas kernel; autograd adds its dW to
        the table gradient of ``rel_embed``'s segment sum. An untied head
        is a ``rel_linear`` with ``out_embed``."""
        cfg = self.cfg
        h = rms_norm(x, p["ln_f"], cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = einsum("bsd,vd->bsv", h, p["embed"])
        else:
            logits = rel_linear(h, p["out_embed"])
        return softcap(logits.float(), cfg.final_softcap)

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

    def _encode(self, p, frames):
        """Whisper's encoder over the stubbed frame embeddings (B, S_enc,
        D): bidirectional layers without RoPE, then a LayerNorm. Outside
        remat, as the reference's ``lax.scan`` over the stacked layers."""
        cfg = self.cfg
        ctx = {"cfg": cfg, "mode": "train", "positions": None, "cache": None}
        x = frames
        for lp in p["encoder"]:
            x, _, _ = block_apply(lp, "enc", x, ctx)
        return layer_norm(x, p["enc_ln_s"], p["enc_ln_b"], cfg.norm_eps)

    def encode(self, frames, params: Optional[Mapping[str, torch.Tensor]] = None):
        """The encoder's output for ``frames`` (B, S_enc, D), which
        ``decode_step(..., enc_out=)`` takes (whisper)."""
        return self._encode(self._tree(params), frames)

    def _positions(self, b: int, s: int, length=None, vis: int = 0):
        """(B, S) positions 0..S-1, or (B, 1) at ``length`` in decode. With
        M-RoPE (qwen2-vl) (B, 3, S) t/h/w triplets: the ``vis`` patches of
        the prefix on a √vis-wide grid at t = 0, the text after them at
        grid, grid + 1, ... on all three axes; a decode step at ``length``
        on all three. As in the reference, decode's position (``length``,
        counting the patches) is not the one a longer prefill gives the
        same token (ROADMAP.md §3)."""
        dev = self.device
        if self.cfg.mrope_sections:
            if length is not None:
                return torch.full((b, 3, 1), int(length), dtype=torch.int32, device=dev)
            grid = max(1, round(vis ** 0.5))
            idx = torch.arange(vis, dtype=torch.int32, device=dev)
            text = grid + torch.arange(s - vis, dtype=torch.int32, device=dev)
            pos = torch.stack([torch.cat([torch.zeros_like(idx), text]),
                               torch.cat([idx // grid, text]),
                               torch.cat([idx % grid, text])])
            return pos[None].expand(b, 3, s)
        if length is not None:
            return torch.full((b, 1), int(length), dtype=torch.int32, device=dev)
        return torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)

    def _share(self, p, ctx) -> None:
        """zamba2's shared block as ``ctx["shared"]``, for every
        ``mamba2_attn`` layer."""
        if self.has_shared:
            ctx["shared"] = p["shared_attn"]

    def _inputs(self, p, batch, mode: str, **ctx):
        """(x, ctx, vis) of a forward over ``batch``: the token embeddings,
        after qwen2-vl's ``patches`` (B, Sv, D) where the batch has them
        (vis = Sv, else 0); the block context, with whisper's encoder
        output over ``frames``."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(p, tokens)
        vis = 0
        if cfg.vis_seq and "patches" in batch:
            vis = batch["patches"].shape[1]
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
            s += vis
        ctx = dict(ctx, cfg=cfg, mode=mode, positions=self._positions(b, s, vis=vis), cache=None)
        if cfg.encoder_layers:
            ctx["enc_out"] = self._encode(p, batch["frames"])
        self._share(p, ctx)
        return x, ctx, vis

    # -- entry points --------------------------------------------------------

    def train_logits(self, batch: Dict[str, Any], params: Optional[Mapping[str, torch.Tensor]] = None):
        """batch: tokens (B,S) [+ frames (B,S_enc,D) | patches (B,Sv,D)].
        Returns (logits (B,S,V) f32 over the text positions, aux), aux the
        blocks' auxiliary losses summed (the MoE's load-balance loss; 0
        for the other kinds)."""
        p = self._tree(params)
        x, ctx, vis = self._inputs(p, batch, "train")
        x, _, aux = self._run_stages(p, x, ctx, None)
        return self._head(p, x[:, vis:]), aux

    def prefill(self, batch: Dict[str, Any], cache_len: int,
                params: Optional[Mapping[str, torch.Tensor]] = None):
        """Logits of the last position (B,1,V) and the caches after the
        prompt (and qwen2-vl's patches before it). ``cache_len`` sizes
        attention caches (the prompt's K/V padded to it); the SSM state is
        O(1)."""
        p = self._tree(params)
        x, ctx, _ = self._inputs(p, batch, "prefill", cache_len=cache_len)
        x, caches, _ = self._run_stages(p, x, ctx, None)
        return self._head(p, x[:, -1:]), caches

    def decode_step(self, token, caches, length, params: Optional[Mapping[str, torch.Tensor]] = None,
                    *, enc_out: Optional[torch.Tensor] = None):
        """token: (B, 1) integer; caches from prefill (or the previous
        step); length: count of valid cache entries (an int); enc_out:
        whisper's encoder output (``encode``), which every decoder layer
        cross-attends to."""
        if self.cfg.encoder_layers and enc_out is None:
            raise ValueError(f"{self.cfg.name}: decode_step needs enc_out (Model.encode)")
        p = self._tree(params)
        x = self._embed(p, token)
        ctx = {"cfg": self.cfg, "mode": "decode",
               "positions": self._positions(token.shape[0], 1, length=length), "length": length}
        if self.cfg.encoder_layers:
            ctx["enc_out"] = enc_out
        self._share(p, ctx)
        x, caches, _ = self._run_stages(p, x, ctx, caches)
        return self._head(p, x), caches


def build_model(cfg, device=None, seed: int = 0) -> Model:
    """The model of ``cfg`` with random weights from ``seed``, made on
    ``device`` ("cuda" unless the caller passes another)."""
    return Model(cfg, device=device, seed=seed)
