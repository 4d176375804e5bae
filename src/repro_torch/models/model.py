"""Model assembly: config → staged decoder (+ optional encoder), as an
``nn.Module``.

Layers are grouped into *stages*; each stage is a repeating superblock
(cfg.pattern) run ``repeats`` times, then its remainder layers
(n_layers % len(pattern)). The reference stacks each superblock's
parameters on a leading axis and runs them with ``jax.lax.scan``; here each
repeat is its own module in a ``ModuleList`` walked in Python, since
PyTorch runs eagerly and has no compile time to save.

On a mesh (``place=``, a ``launch.sharding.Placement``, or a model built
with ``mesh=``) every kind runs on the rank's shards: attention (full,
windowed, cross or MLA on the rank's heads) and MLP column- then
row-parallel, the experts split over the model ranks, the SSM layers on
the rank's channels or heads (``models/ssm.py``), zamba2's shared block
placed as the attention layers are, whisper's encoder whole on every
rank (its leaves replicated), the embedding and the head (tied or not)
split over the vocabulary, the FSDP leaves gathered per layer, the batch's rows split over the data ranks —
the ("pod", "data") fold where the mesh has a pod axis — (the reference's
``hint(x, DP, ...)`` sites, which cut a whole batch to the rank's rows
there and are no-ops off a mesh), qwen2-vl's patches and M-RoPE positions
and whisper's frames and encoder output cut at the rows the tokens are.
The logits each rank returns are whole: the head's vocabulary shards, and
in serving the batch's rows, are gathered; so is ``encode``'s output.

Parameters are made directly on the target device from an explicit
``torch.Generator`` there: a full-width model (29 GB in f32 for
falcon-mamba-7b) is never built on the host first. ``build_model`` runs on
"cuda" unless the caller passes ``device="cpu"`` (or ``"meta"``: shapes
only). Built with ``mesh=``, each leaf is cut to the rank's shard as soon
as it is drawn, in the mesh-less model's draw order: a rank never holds
more than its shards and one leaf whole, and its shards are bits of the
mesh-less model's.

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
from repro_torch.launch.sharding import DP, Placement, hint
from repro_torch.relational import rel_embed, rel_linear

from .blocks import block_apply, block_init, shared_attn_init
from .common import MetaGenerator, dense_init, einsum, embed_init, keeping, layer_norm, rms_norm, softcap


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

    def __init__(self, cfg, device=None, seed: int = 0, *, mesh=None):
        super().__init__()
        dev = resolve_device(device, owner="repro_torch.models.Model")
        gen = (MetaGenerator() if dev.type == "meta"
               else torch.Generator(device=dev).manual_seed(seed))
        dt = getattr(torch, cfg.dtype)
        self.cfg = cfg
        self.stage_specs = stages_of(cfg)
        self.placement = None if mesh is None else Placement(cfg, mesh)
        cut = self._cut
        self.embed = nn.Parameter(cut("embed", embed_init(gen, (cfg.vocab, cfg.d_model), dtype=dt)))
        self.ln_f = nn.Parameter(torch.zeros((cfg.d_model,), dtype=dt, device=dev))
        if not cfg.tie_embeddings:
            self.out_embed = nn.Parameter(cut("out_embed", dense_init(gen, (cfg.d_model, cfg.vocab), dtype=dt)))
        self.has_shared = "mamba2_attn" in _all_kinds(self.stage_specs)
        if self.has_shared:
            self.shared_attn = self._drawn_block("shared_attn.", gen, lambda g: shared_attn_init(g, cfg))
        if cfg.encoder_layers:
            self.encoder = nn.ModuleList(self._drawn_block(f"encoder.{r}.", gen,
                                                           lambda g: block_init(g, "enc", cfg))
                                         for r in range(cfg.encoder_layers))
            self.enc_ln_s = nn.Parameter(torch.ones((cfg.d_model,), dtype=dt, device=dev))
            self.enc_ln_b = nn.Parameter(torch.zeros((cfg.d_model,), dtype=dt, device=dev))
        self.stages = nn.ModuleList(
            nn.ModuleDict({
                "scan": nn.ModuleList(
                    nn.ModuleDict({
                        f"{i}:{kind}": self._drawn_block(f"stages.{si}.scan.{r}.{i}:{kind}.", gen,
                                                         lambda g, kind=kind: block_init(g, kind, cfg))
                        for i, kind in enumerate(st.pattern)
                    })
                    for r in range(st.repeats)
                ),
                "tail": nn.ModuleList(self._drawn_block(f"stages.{si}.tail.{i}.", gen,
                                                        lambda g, kind=kind: block_init(g, kind, cfg))
                                      for i, kind in enumerate(st.tail)),
            })
            for si, st in enumerate(self.stage_specs)
        )

    def _cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """``t``, or on a mesh the rank's shard of parameter ``name``."""
        return t if self.placement is None else self.placement.cut(name, t)

    def _drawn_block(self, prefix: str, gen, init) -> nn.Module:
        """``init(gen)``'s block; on a mesh with each leaf the initializers
        draw cut to the rank's shard as soon as it is drawn (one MoE leaf of
        deepseek-v3 takes 15 GB whole), the others after. The names of the
        drawn leaves, in draw order, come from a draw of the block on
        ``meta`` whose leaves are kept as the parameters the block holds."""
        if self.placement is None:
            return init(gen)
        marks = []

        def mark(w):
            marks.append(nn.Parameter(w))
            return marks[-1]

        with keeping(mark):
            where = {id(p): n for n, p in init(MetaGenerator()).named_parameters()}
        drawn = iter([where[id(p)] for p in marks])

        def keep(w):
            return self.placement.cut(prefix + next(drawn), w)

        with keeping(keep):
            block = init(gen)
        for name, p in block.named_parameters():
            p.data = self.placement.cut(prefix + name, p.data)
        return block

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _tree(self, params, place=None):
        """What the entry points walk: the module itself, or ``params``
        as a tree (``param_tree``); on a mesh the rank's shards of
        ``params`` (or of the module's own), as a tree."""
        if place is None:
            return self if params is None else param_tree(params)
        return param_tree(place.shard(dict(self.named_parameters()) if params is None else params))

    def _place(self, place):
        """The placement an entry point runs on: ``place``, else the one
        the model was built on (None: one device)."""
        return place if place is not None else self.placement

    @staticmethod
    def _on(place):
        """The context of a step on ``place`` (none off a mesh)."""
        return contextlib.nullcontext() if place is None else place.active()

    def __getitem__(self, name: str):
        return getattr(self, name)

    # -- embedding / head ---------------------------------------------------

    def _embed(self, p, tokens, place=None):
        """The token embeddings. On a mesh a whole batch is cut to the
        rank's rows first (the reference's ``hint(x, DP, None, None)`` on
        the embeddings, taken on the tokens they are looked up from), and
        a vocabulary split over the model ranks is looked up in the rank's
        rows (zero rows for the others' ids), then summed over the
        ranks."""
        cfg = self.cfg
        tokens = hint(tokens, DP, None)
        ids = tokens.reshape(-1)
        table = p["embed"] if place is None else place.gather_tree(p["embed"], "embed.")
        if place is not None and place.splits(cfg.vocab):
            x = place.reduce(rel_embed(table, ids, start=place.index("model") * table.shape[0]))
        else:
            x = rel_embed(table, ids)
        x = x.reshape(*tokens.shape, cfg.d_model)
        if cfg.embed_scale:
            # sqrt(d_model) rounded to the activations' dtype first, as the
            # reference's jnp.asarray(cfg.d_model**0.5, x.dtype)
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
        return x

    def _head(self, p, x, place=None):
        """The logits, f32, the final softcap applied to the whole. A tied
        head (gemma) is the product with the embedding table through
        ``common.einsum``, as the reference's ``jnp.einsum`` outside every
        Pallas kernel; autograd adds its dW to the table gradient of
        ``rel_embed``'s segment sum. An untied head is a ``rel_linear``
        with ``out_embed``. On a mesh that splits the vocabulary either is
        column-parallel on the rank's rows of the vocabulary, its logits
        gathered whole; a table split over the data ranks too (FSDP) is
        gathered here as for the lookup, each gather's reduce-scatter
        adding its part of the table's gradient."""
        cfg = self.cfg
        h = rms_norm(x, p["ln_f"], cfg.norm_eps)
        name = "embed" if cfg.tie_embeddings else "out_embed"
        w = p[name] if place is None else place.gather_tree(p[name], name + ".")

        def product(h):
            return einsum("bsd,vd->bsv", h, w) if cfg.tie_embeddings else rel_linear(h, w)

        if place is not None and place.splits(cfg.vocab):
            logits = place.gather_from(product(place.copy_to(h)), -1)
        else:
            logits = product(h)
        return softcap(logits.float(), cfg.final_softcap)

    @staticmethod
    def _whole_rows(logits, place):
        """Serving's logits (or ``encode``'s output) with every data rank's
        rows (forward only)."""
        return logits if place is None else place.gather_from(logits, 0, place.batch)

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
        place = ctx.get("place")

        def gathered(node, prefix):
            """A layer's parameters with its FSDP leaves gathered, on a mesh."""
            return node if place is None else place.gather_tree(node, prefix)

        def superblock(pattern, sblock, x, entry, prefix=""):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            new_entry = {}
            if place is not None:
                x = hint(x, DP, None, None, whole=(ctx["batch"],) + tuple(x.shape[1:]))
                sblock = gathered(sblock, prefix)
            for i, kind in enumerate(pattern):
                key = f"{i}:{kind}"
                x, new_entry[key], a = block_apply(
                    sblock[key], kind, x,
                    dict(ctx, cache=entry[key] if entry is not None else None),
                )
                aux = aux + a
            return x, new_entry, aux

        def rematted(pattern, sblock, x, prefix):
            db = session.current()

            def run(x):
                x, _, aux = superblock(pattern, sblock, x, None, prefix)
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
            if not st.repeats and not st.tail:
                # a stage of no layers (deepseek-v3 with first_k_dense =
                # n_layers) has no parameters: a params dict's tree has no
                # entry for it
                new_caches.append({"scan": [], "tail": []})
                continue
            stage = p["stages"][si]
            scan_cache = []
            for r, sblock in enumerate(stage["scan"]):
                prefix = f"stages.{si}.scan.{r}."
                if remat:
                    x, a = rematted(st.pattern, sblock, x, prefix)
                    new_entry = {f"{i}:{kind}": {} for i, kind in enumerate(st.pattern)}
                else:
                    entry = caches[si]["scan"][r] if caches is not None else None
                    x, new_entry, a = superblock(st.pattern, sblock, x, entry, prefix)
                aux_total = aux_total + a
                scan_cache.append(new_entry)
            tail_cache = []
            for i, kind in enumerate(st.tail):
                x, c, a = block_apply(
                    gathered(stage["tail"][i], f"stages.{si}.tail.{i}."), kind, x,
                    dict(ctx, cache=caches[si]["tail"][i] if caches is not None else None),
                )
                aux_total = aux_total + a
                tail_cache.append(c)
            new_caches.append({"scan": scan_cache, "tail": tail_cache})
        return x, new_caches, aux_total

    def _encode(self, p, frames, place=None):
        """Whisper's encoder over the stubbed frame embeddings (B, S_enc,
        D): bidirectional layers without RoPE, then a LayerNorm. Outside
        remat, as the reference's ``lax.scan`` over the stacked layers. On
        a mesh over the rank's rows of the whole batch's ``frames``, with
        every leaf whole on every rank (the placement replicates them:
        ROADMAP.md §3), so no collective runs here."""
        cfg = self.cfg
        ctx = {"cfg": cfg, "mode": "train", "positions": None, "cache": None}
        x = frames if place is None else _rows(frames)
        for lp in p["encoder"]:
            x, _, _ = block_apply(lp, "enc", x, ctx)
        return layer_norm(x, p["enc_ln_s"], p["enc_ln_b"], cfg.norm_eps)

    def encode(self, frames, params: Optional[Mapping[str, torch.Tensor]] = None, *, place=None):
        """The encoder's output for ``frames`` (B, S_enc, D), which
        ``decode_step(..., enc_out=)`` takes (whisper). On a mesh
        (``place``, or the model's own) the whole batch's, as off one."""
        place = self._place(place)
        with self._on(place):
            p = self._tree(params, place)
            return self._whole_rows(self._encode(p, frames, place), place)

    def _positions(self, b: int, s: int, length=None, vis: int = 0):
        """(B, S) positions 0..S-1, or (B, 1) at ``length`` in decode. With
        M-RoPE (qwen2-vl) (B, 3, S) t/h/w triplets: the ``vis`` patches of
        the prefix on a √vis-wide grid at t = 0, the text after them at
        grid, grid + 1, ... on all three axes; a decode step at ``length``
        on all three. As in the reference, decode's position (``length``,
        counting the patches) is not the one a longer prefill gives the
        same token (ROADMAP.md §3). On a mesh ``b`` is the whole batch's,
        and the rank's rows are cut from them, as from the tokens."""
        return _rows(self._batch_positions(b, s, length, vis))

    def _batch_positions(self, b: int, s: int, length=None, vis: int = 0):
        """``_positions`` of every row of a batch of ``b``."""
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
        ``mamba2_attn`` layer; on a mesh with its FSDP leaves gathered once
        for the step (the reduce-scatter of their gradient sums every
        layer's use)."""
        if self.has_shared:
            place = ctx.get("place")
            sp = p["shared_attn"]
            ctx["shared"] = sp if place is None else place.gather_tree(sp, "shared_attn.")

    def _inputs(self, p, batch, mode: str, place=None, **ctx):
        """(x, ctx, vis) of a forward over ``batch``: the token embeddings,
        after qwen2-vl's ``patches`` (B, Sv, D) where the batch has them
        (vis = Sv, else 0); the block context, with whisper's encoder
        output over ``frames``; on a mesh the rank's rows — of the tokens,
        the patches, the positions and the frames alike — with the
        placement and the whole batch's size in the context."""
        cfg = self.cfg
        tokens = batch["tokens"]
        if place is not None:
            ctx = dict(ctx, place=place, batch=tokens.shape[0])
        x = self._embed(p, tokens, place)
        s = x.shape[1]
        vis = 0
        if cfg.vis_seq and "patches" in batch:
            vis = batch["patches"].shape[1]
            x = torch.cat([_rows(batch["patches"]).to(x.dtype), x], dim=1)
            s += vis
        ctx = dict(ctx, cfg=cfg, mode=mode, positions=self._positions(tokens.shape[0], s, vis=vis),
                   cache=None)
        if cfg.encoder_layers:
            ctx["enc_out"] = self._encode(p, batch["frames"], place)
        self._share(p, ctx)
        return x, ctx, vis

    # -- entry points --------------------------------------------------------

    def train_logits(self, batch: Dict[str, Any], params: Optional[Mapping[str, torch.Tensor]] = None,
                     *, place=None):
        """batch: tokens (B,S) [+ frames (B,S_enc,D) | patches (B,Sv,D)].
        Returns (logits (B,S,V) f32 over the text positions, aux), aux the
        blocks' auxiliary losses summed (the MoE's load-balance loss; 0
        for the other kinds). On a mesh (``place``, or the model's own)
        the logits are the rank's rows of the batch, over the whole
        vocabulary, and aux the mean over those rows."""
        place = self._place(place)
        with self._on(place):
            p = self._tree(params, place)
            x, ctx, vis = self._inputs(p, batch, "train", place)
            x, _, aux = self._run_stages(p, x, ctx, None)
            return self._head(p, x[:, vis:], place), aux

    def prefill(self, batch: Dict[str, Any], cache_len: int,
                params: Optional[Mapping[str, torch.Tensor]] = None, *, place=None):
        """Logits of the last position (B,1,V) and the caches after the
        prompt (and qwen2-vl's patches before it). ``cache_len`` sizes
        attention caches (the prompt's K/V padded to it); the SSM state is
        O(1). On a mesh the logits are whole and the caches the rank's:
        its rows of the batch and the KV heads its attention computes
        (``Placement.kv_heads``)."""
        place = self._place(place)
        with self._on(place):
            p = self._tree(params, place)
            x, ctx, _ = self._inputs(p, batch, "prefill", place, cache_len=cache_len)
            x, caches, _ = self._run_stages(p, x, ctx, None)
            return self._whole_rows(self._head(p, x[:, -1:], place), place), caches

    def decode_step(self, token, caches, length, params: Optional[Mapping[str, torch.Tensor]] = None,
                    *, enc_out: Optional[torch.Tensor] = None, place=None):
        """token: (B, 1) integer; caches from prefill (or the previous
        step); length: count of valid cache entries (an int); enc_out:
        whisper's encoder output (``encode``), which every decoder layer
        cross-attends to. On a mesh ``token`` is the whole batch's, the
        caches the rank's, ``enc_out`` the whole batch's or the rank's rows,
        and the logits whole."""
        if self.cfg.encoder_layers and enc_out is None:
            raise ValueError(f"{self.cfg.name}: decode_step needs enc_out (Model.encode)")
        place = self._place(place)
        with self._on(place):
            p = self._tree(params, place)
            x = self._embed(p, token, place)
            ctx = {"cfg": self.cfg, "mode": "decode",
                   "positions": self._positions(token.shape[0], 1, length=length), "length": length}
            if place is not None:
                ctx.update(place=place, batch=token.shape[0])
            if self.cfg.encoder_layers:
                ctx["enc_out"] = _rows(enc_out, token.shape[0])
            self._share(p, ctx)
            x, caches, _ = self._run_stages(p, x, ctx, caches)
            return self._whole_rows(self._head(p, x, place), place), caches


def _rows(t: torch.Tensor, b: Optional[int] = None) -> torch.Tensor:
    """The rank's rows of a batch's ``t`` (its leading axis) on the active
    placement, the cut the tokens take: ``t`` whole, or with ``b`` (the
    whole batch's rows) whole or already the rank's; off a mesh ``t``."""
    whole = None if b is None else (b,) + tuple(t.shape[1:])
    return hint(t, DP, *([None] * (t.dim() - 1)), whole=whole)


def build_model(cfg, device=None, seed: int = 0, *, mesh=None) -> Model:
    """The model of ``cfg`` with random weights from ``seed``, made on
    ``device`` ("cuda" unless the caller passes another); with ``mesh`` (a
    DeviceMesh, or a mapping of axis sizes on ``meta``: rank 0's) the
    rank's shards of them (``Model``)."""
    return Model(cfg, device=device, seed=seed, mesh=mesh)


def param_shapes(cfg) -> Dict[str, Tuple[int, ...]]:
    """name → shape of every parameter of ``cfg``'s model (built on the
    ``meta`` device: nothing is allocated or drawn)."""
    return {n: tuple(p.shape) for n, p in Model(cfg, device="meta").named_parameters()}
