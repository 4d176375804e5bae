"""Serving steps: batched prefill and single-token decode, on one device
or on a mesh.

``make_prefill_step`` / ``make_decode_step`` wrap ``Model.prefill`` /
``Model.decode_step`` in ``torch.inference_mode()``: without it every
``autograd.Function`` on the path (``rel_linear``, ``rel_embed``,
``ssm_scan``) saves its inputs for a backward that never comes, and a
full-width prefill would hold each layer's (B,S,C,N) f32 tensors — 1 GiB
each at B·S = 2048 — for all 64 layers at once.

Attention layers carry a K/V cache of ``cache_len`` positions, written at
``length`` by each decode step, which then advances ``length`` by one as
the reference's caller does; gemma's sliding-window (``local``) layers a
right-aligned one of ``min(window, cache_len)`` positions, shifted left by
each step; SSM layers carry (conv window, state): O(1) per step.
zamba2's ``mamba2_attn`` layers carry both: their Mamba-2 state (``ssm2``)
and the K/V cache of the shared attention block at that layer
(``shared_kv``). MLA layers (deepseek-v3) carry the compressed cache:
``{"c": (B, T, kv_lora_rank), "r": (B, T, rope_head_dim)}`` per position;
whisper's decoder layers the K/V cache of their self-attention (the
cross-attention recomputes its K/V from the encoder output, ``enc_out``,
at every step and keeps none).

``BucketedPrefill`` is the session-backed bucketing engine underneath the
serving front door: one prefill step per (batch, seq) bucket, held in a
``repro_torch.Database`` session's executable cache with LRU eviction
(``max_entries``) and a ``warmup(buckets=...)`` sweep. It is an internal
detail of ``serving.service.Endpoint`` (``db.endpoint`` /
``repro_torch.serve``) — the async request path with continuous batching,
decode-step bucketing and load shedding lives there.

The port's caches have their batch on axis 0 in every leaf: the
reference stacks a stage's repeats on axis 0 of each ``scan`` leaf (so its
batch axis is 1 there), the port keeps one entry per repeat
(``caches[si]["scan"][r]``). ``map_cache`` walks that layout.

On a mesh (``mesh=``, or the ``db``'s), the steps run every block kind
tensor- and expert-parallel on the rank's shards of the parameters
(``launch/sharding.py``), whisper's encoder whole on every rank and
qwen2-vl's vision prefix with its rows: every
rank is given the whole batch and returns the whole logits, and keeps its
own caches (its rows of the batch, the KV heads its attention computes,
its SSM channels' state: ``init_cache(..., place=)``; an MLA layer's
latent cache is whole, as every head reads it). The steps cut the shards
through ``_PlacedParamsCache``, once per live parameter dict, as the
reference's decode step places its parameters once per version. An
endpoint serves on several ranks through ``Endpoint.follow()``
(serving/service.py): rank 0 admits the requests and broadcasts each
step's header, and the other ranks run the same steps.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.session import resolve_device
from repro_torch.models.model import Model, stages_of


def _attn_cache_entry(cfg, kind: str, batch: int, cache_len: int, device: torch.device,
                      kv_heads: Optional[int] = None, ssm_split: int = 1):
    dt = getattr(torch, cfg.dtype)
    if kind in ("mla", "mla_moe"):
        return {"kv": {
            "c": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dt, device=device),
            "r": torch.zeros((batch, cache_len, cfg.rope_head_dim), dtype=dt, device=device),
        }}

    def kv(width=cache_len):
        shape = (batch, width, cfg.n_kv_heads if kv_heads is None else kv_heads, cfg.hd())
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    if kind in ("attn", "global", "moe", "dec"):
        return {"kv": kv()}
    if kind == "local":
        return {"kv": kv(min(cfg.window or cache_len, cache_len))}
    # an SSM layer on a mesh carries the state of the rank's channels
    # (heads) and its conv window of its columns
    c = cfg.ssm_expand * cfg.d_model // ssm_split
    if kind == "mamba1":
        return {
            "ssm1": {
                "conv": torch.zeros(
                    (batch, cfg.conv_width - 1, c), dtype=dt, device=device
                ),
                "ssm": torch.zeros((batch, c, cfg.ssm_state), dtype=torch.float32, device=device),
            }
        }
    if kind in ("mamba2", "mamba2_attn"):
        entry = {
            "ssm2": {
                "conv": torch.zeros(
                    (batch, cfg.conv_width - 1, c + 2 * cfg.ssm_state // ssm_split), dtype=dt,
                    device=device,
                ),
                "ssm": torch.zeros(
                    (batch, c // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim),
                    dtype=torch.float32, device=device,
                ),
            }
        }
        if kind == "mamba2_attn":
            entry["shared_kv"] = kv()
        return entry
    raise ValueError(f"unknown block kind {kind}")


def init_cache(cfg, batch: int, cache_len: int, device=None, *, place=None):
    """Zero-initialized caches in ``Model``'s layout, on ``device`` ("cuda"
    unless the caller passes another). ``cache_len`` sizes attention
    caches (a ``local`` layer's is ``min(window, cache_len)`` wide). With
    ``place`` (a ``launch.sharding.Placement``) the rank's cache of a
    whole batch of ``batch`` rows: its rows, the KV heads its attention
    computes, and an SSM layer's state and conv window of the rank's
    channels (heads) and columns."""
    dev = resolve_device(device, owner="repro_torch.serving.init_cache")
    heads, split = None, 1
    if place is not None:
        # the rank's rows: the batch is cut over the whole data fold
        # (("pod", "data") where the mesh has a pod axis)
        batch //= place.size(place.batch) if batch % place.size(place.batch) == 0 else 1
        heads, split = place.kv_heads(cfg) if cfg.n_heads else None, place.size("model")
    caches = []
    for st in stages_of(cfg):
        scan = [
            {f"{i}:{kind}": _attn_cache_entry(cfg, kind, batch, cache_len, dev, heads, split)
             for i, kind in enumerate(st.pattern)}
            for _ in range(st.repeats)
        ]
        tail = [_attn_cache_entry(cfg, kind, batch, cache_len, dev, heads, split) for kind in st.tail]
        caches.append({"scan": scan, "tail": tail})
    return caches


def map_cache(fn: Callable[[torch.Tensor], torch.Tensor], caches):
    """``fn`` applied to every tensor of a cache tree (dicts, lists and
    tuples of tensors); anything else passes through."""
    if isinstance(caches, dict):
        return {k: map_cache(fn, v) for k, v in caches.items()}
    if isinstance(caches, (list, tuple)):
        return type(caches)(map_cache(fn, v) for v in caches)
    return fn(caches) if isinstance(caches, torch.Tensor) else caches


def _session(db):
    """``db.activate()``, or no change of session when ``db`` is None."""
    return db.activate() if db is not None else contextlib.nullcontext()


def _placement(model: Model, mesh, db):
    """The ``Placement`` of a step on ``mesh`` (else ``db``'s mesh; a
    ``launch.mesh.resolve_mesh`` spec string is resolved), or None off a
    mesh: the model's own where it was built on that mesh."""
    if db is not None and mesh is None:
        mesh = db.mesh
    if isinstance(mesh, str):
        from repro_torch.launch.mesh import resolve_mesh

        mesh = resolve_mesh(mesh, device_type=(db.device if db is not None else model.device).type)
    if mesh is None:
        return None
    own = getattr(model, "placement", None)
    if own is not None and own.mesh is mesh:
        return own
    from repro_torch.launch.sharding import Placement

    return Placement(model.cfg, mesh)


class _StrongRef:
    """Callable strong-reference fallback for anchors that reject
    weakrefs — the LRU capacity still bounds what it can pin."""

    __slots__ = ("_obj",)

    def __init__(self, obj):
        self._obj = obj

    def __call__(self):
        return self._obj


class _PlacedParamsCache:
    """Bounded cache of the rank's shards of parameter dicts.

    Entries are keyed on a **(weakref, id) identity pair**: ``id(params)``
    indexes the cache, and a weak reference to the dict's first tensor
    validates the hit (two distinct dicts can recycle the same ``id``
    across garbage collections — the live-leaf identity check makes that
    impossible to alias). Entries are evicted three ways: the weakref
    callback drops an entry the moment its source params die (so a
    long-running server never pins shards of stale params), LRU order
    bounds the cache at ``capacity``, and ``clear()`` empties it."""

    def __init__(self, capacity: int = 4):
        self.capacity = capacity
        self._entries: "OrderedDict[int, Tuple[Callable, Any]]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()

    @staticmethod
    def _anchor(params):
        leaves = list(params.values()) if isinstance(params, dict) else []
        return leaves[0] if leaves else params

    def place(self, params, shard: Callable):
        """``shard(params)``, cached per live params object."""
        key = id(params)
        anchor = self._anchor(params)
        hit = self._entries.get(key)
        if hit is not None and hit[0]() is anchor:
            self._entries.move_to_end(key)
            return hit[1]
        placed = shard(params)
        entries = self._entries

        def _on_death(ref, _key=key):
            ent = entries.get(_key)
            if ent is not None and ent[0] is ref:
                del entries[_key]

        try:
            ref: Callable = weakref.ref(anchor, _on_death)
        except TypeError:
            ref = _StrongRef(anchor)
        entries[key] = (ref, placed)
        entries.move_to_end(key)
        while len(entries) > self.capacity:
            entries.popitem(last=False)
        return placed


def make_prefill_step(model: Model, cache_len: int, *, mesh=None, db=None):
    """``prefill_step(batch, params=None) → (logits (B,1,V), caches)``
    without autograd. ``params`` is what ``Model.prefill`` takes (None: the
    module's own tensors). ``db`` (a ``repro_torch.Database``) is the
    session the step runs under — its dispatch table picks the kernels —
    else the ambient one; ``BucketedPrefill`` is the bucketed front end
    over this. ``mesh`` (a DeviceMesh or a ``launch/mesh.resolve_mesh``
    spec string such as ``"host"``; default ``db.mesh``) runs the step on
    the rank's shards of ``params``, cut once per live params dict
    (``_PlacedParamsCache``; module docstring)."""
    place = _placement(model, mesh, db)
    placed = _PlacedParamsCache()
    own = dict(model.named_parameters()) if place is not None else None

    def prefill_step(batch, params=None):
        kw = {}
        if place is not None:
            params = placed.place(own if params is None else params, place.shard)
            kw["place"] = place
        with _session(db), torch.inference_mode():
            return model.prefill(batch, cache_len, params=params, **kw)

    return prefill_step


def make_encode_step(model: Model, *, mesh=None, db=None):
    """``encode_step(frames, params=None) → enc_out`` without autograd:
    whisper's encoder output (``Model.encode``), which each decode step
    takes; ``params``, ``mesh`` and ``db`` as in ``make_prefill_step``. On
    a mesh the encoder runs on the rank's shards of ``params`` (cut once
    per live params dict) and rows of ``frames``, and ``enc_out`` is the
    whole batch's, as a mesh decode step takes it."""
    place = _placement(model, mesh, db)
    placed = _PlacedParamsCache()
    own = dict(model.named_parameters()) if place is not None else None

    def encode_step(frames, params=None):
        kw = {}
        if place is not None:
            params = placed.place(own if params is None else params, place.shard)
            kw["place"] = place
        with _session(db), torch.inference_mode():
            return model.encode(frames, params, **kw)

    return encode_step


def make_decode_step(model: Model, *, mesh=None, db=None, on_trace: Optional[Callable[[], None]] = None):
    """``decode_step(token, caches, length, params=None, enc_out=None) →
    (logits (B,1,V), caches)`` without autograd; ``params``, ``mesh`` and
    ``db`` as in ``make_prefill_step``; ``enc_out`` whisper's encoder
    output (``make_encode_step``). On a mesh the rank's shards of
    ``params`` are cut once per live params dict (``_PlacedParamsCache``,
    the step's ``_placed_cache``), so a token's step re-walks nothing.
    ``on_trace`` (internal; the serving telemetry hook) is called at the
    step's first call: where the reference counts a jit trace per shape
    class, an eager step has one first call, and the serving front door
    builds one step per batch bucket."""
    traced = False
    place = _placement(model, mesh, db)
    placed = _PlacedParamsCache()
    own = dict(model.named_parameters()) if place is not None else None

    def decode_step(token, caches, length, params=None, enc_out=None):
        nonlocal traced
        if on_trace is not None and not traced:
            traced = True
            on_trace()
        kw = {} if enc_out is None else {"enc_out": enc_out}
        if place is not None:
            params = placed.place(own if params is None else params, place.shard)
            kw["place"] = place
        with _session(db), torch.inference_mode():
            return model.decode_step(token, caches, length, params=params, **kw)

    if place is not None:
        decode_step._placed_cache = placed  # introspection for tests
    return decode_step


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` with zero rows appended on axis 0 up to ``rows``."""
    if x.shape[0] == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])


# ---------------------------------------------------------------------------
# BucketedPrefill: the session-backed bucketed prefill engine
# ---------------------------------------------------------------------------


class BucketedPrefill:
    """Bucketed prefill over a ``repro_torch.Database`` session: one
    prefill step per **(batch, seq) bucket**, held in the session's
    executable cache with LRU eviction and hit/evict accounting
    (``db.counters()["cache"]``).

    Requests are rounded up to the smallest configured bucket with the
    same sequence length (zero-padded on the **batch** dim; logits and
    caches are sliced back), so mixed-batch traffic builds one step per
    bucket instead of one per shape. The sequence dim is never padded:
    this repo's models emit last-position-only prefill logits and carry
    unmasked recurrent (conv/SSM) state, so right-padding the sequence
    would score the pad token — pad prompts to a bucketed length in the
    tokenizer instead. ``warmup(params, ...)`` sweeps the configured
    buckets through their first call before traffic arrives.

    ``db`` shares an existing session (its ``max_cache_entries`` bounds
    the cache); without one, a private session is created on ``device``
    ("cuda" unless the caller passes another) with ``max_entries`` as the
    bound and ``mesh`` as its mesh. ``mesh`` (a DeviceMesh or a
    ``launch/mesh.resolve_mesh`` spec string; default the session's) is
    the mesh each bucket's step runs on (``make_prefill_step(mesh=)``).

    This is the bucketing engine *inside* the serving front door — build
    endpoints with ``db.endpoint(...)`` / ``repro_torch.serve(db, ...)``
    (serving/service.py), which add the async request path, continuous
    batching, decode bucketing and load shedding on top.
    """

    def __init__(
        self,
        model: Model,
        cache_len: int,
        *,
        db=None,
        buckets: Optional[Sequence[Tuple[int, int]]] = None,
        max_entries: int = 8,
        device=None,
        mesh=None,
        on_compile: Optional[Callable[[], None]] = None,
    ):
        if db is None:
            from repro_torch.core.session import Database

            db, mesh = Database(device, mesh=mesh, max_cache_entries=max_entries), None
        self.db = db
        self._mesh = mesh
        self.model = model
        self.cache_len = cache_len
        self.buckets: Optional[List[Tuple[int, int]]] = (
            sorted({(int(b), int(s)) for b, s in buckets}) if buckets else None
        )
        #: telemetry hook: called once per bucket step built (a
        #: session-cache miss) — the endpoint counts these under
        #: ``serve/prefill/compiles``.
        self.on_compile = on_compile

    @property
    def mesh(self):
        """The mesh the bucket steps run on: the one passed with a shared
        ``db`` (a spec string resolved at first use), else the session's."""
        if isinstance(self._mesh, str):
            from repro_torch.launch.mesh import resolve_mesh

            self._mesh = resolve_mesh(self._mesh, device_type=self.db.device.type)
        return self.db.mesh if self._mesh is None else self._mesh

    def bucket_for(self, batch: int, seq: int) -> Tuple[int, int]:
        """The smallest configured (batch, seq) bucket that fits the
        request — batch rounds up, the sequence length must match a
        bucket exactly (see the class docstring) — or the exact shape
        when no buckets were configured."""
        if not self.buckets:
            return (batch, seq)
        fitting = [
            (b, s) for b, s in self.buckets if b >= batch and s == seq
        ]
        if not fitting:
            raise ValueError(
                f"no bucket fits (batch={batch}, seq={seq}); configured "
                f"buckets: {self.buckets} (batch rounds up, seq must "
                f"match exactly — pad prompts to a bucket length "
                f"upstream)"
            )
        return min(fitting, key=lambda bs: bs[0])

    def max_batch(self, seq: int) -> Optional[int]:
        """The largest configured bucket batch at sequence length ``seq``
        (None in exact-shape mode) — the coalescing cap of the serving
        front door's batch formation."""
        if not self.buckets:
            return None
        fitting = [b for b, s in self.buckets if s == seq]
        return max(fitting) if fitting else 0

    def _compiled(self, bucket: Tuple[int, int]):
        mesh = self.mesh
        key = ("prefill", id(self.model), self.cache_len, bucket, None if mesh is None else id(mesh))

        def build():
            if self.on_compile is not None:
                self.on_compile()
            return make_prefill_step(self.model, self.cache_len, mesh=mesh, db=self.db)

        return self.db.cached_executable(key, build)

    @staticmethod
    def _pad_batch(batch: Dict[str, Any], bsz: int, bucket: Tuple[int, int]):
        """Each tensor of ``batch`` whose leading dim is the request's
        batch, zero-padded to the bucket's."""
        b0 = bucket[0]
        return {
            k: pad_rows(v, b0)
            if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == bsz and b0 != bsz
            else v
            for k, v in batch.items()
        }

    @staticmethod
    def _slice_cache_batch(caches, bsz: int, bucket_b: int):
        """Cut the bucket-padding rows back out of the cache tree so
        decode continues at the *request* batch. The batch axis is 0 in
        every leaf of the port's cache layout (module docstring); leaves
        without the bucket batch there (e.g. scalars) pass through."""
        if bsz == bucket_b:
            return caches
        return map_cache(
            lambda t: t[:bsz] if t.dim() and t.shape[0] == bucket_b else t, caches
        )

    def prefill(self, params, batch: Dict[str, Any]):
        """Bucketed prefill: pads the request's batch dim to its bucket,
        steps the bucket's cached step, and slices both the logits and
        the caches' batch dim back to the request batch — decode then
        continues seamlessly at the request batch while the step stays
        amortized per bucket."""
        tokens = batch["tokens"]
        bsz, seq = int(tokens.shape[0]), int(tokens.shape[1])
        bucket = self.bucket_for(bsz, seq)
        step = self._compiled(bucket)
        logits, caches = step(self._pad_batch(batch, bsz, bucket), params)
        return (
            logits[:bsz],
            self._slice_cache_batch(caches, bsz, bucket[0]),
        )

    def warmup(self, params, *, buckets=None, batch_fn=None) -> None:
        """Run the given (default: all configured) buckets' steps once
        before traffic arrives. ``batch_fn(batch, seq)`` builds the
        exemplar batch; the default is a zero token batch on the session's
        device, which suits token-only models: an encoder-decoder or
        vision config (reading ``frames`` / ``patches``) must pass
        ``batch_fn``, or warmup raises ``ValueError`` naming what the
        model reads."""
        todo = buckets if buckets is not None else (self.buckets or ())
        for b, s in todo:
            step = self._compiled((int(b), int(s)))
            ex = (batch_fn(int(b), int(s)) if batch_fn is not None else
                  {"tokens": torch.zeros((int(b), int(s)), dtype=torch.int32, device=self.db.device)})
            try:
                step(ex, params)
            except KeyError as e:
                raise ValueError(
                    f"warmup's default exemplar batch carries only 'tokens' but the model also "
                    f"reads {e}; pass batch_fn=lambda b, s: {{...}} building the full input batch "
                    "(e.g. repro_torch.data.batch_for)"
                ) from e
        if self.db.device.type == "cuda":
            torch.cuda.synchronize(self.db.device)
