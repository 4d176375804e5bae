"""Serving steps: batched prefill and single-token decode, on one device.

``make_prefill_step`` / ``make_decode_step`` wrap ``Model.prefill`` /
``Model.decode_step`` in ``torch.inference_mode()``: without it every
``autograd.Function`` on the path (``rel_linear``, ``rel_embed``,
``ssm_scan``) saves its inputs for a backward that never comes, and a
full-width prefill would hold each layer's (B,S,C,N) f32 tensors — 1 GiB
each at B·S = 2048 — for all 64 layers at once.

Attention layers carry a K/V cache of ``cache_len`` positions, written at
``length`` by each decode step, which then advances ``length`` by one as
the reference's caller does; SSM layers carry (conv window, state): O(1)
per step. zamba2's ``mamba2_attn`` layers carry both: their Mamba-2 state
(``ssm2``) and the K/V cache of the shared attention block at that layer
(``shared_kv``).

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
(``caches[si]["scan"][r]``). ``map_cache`` walks that layout. The
reference's mesh placement of the parameters (``mesh=``,
``_PlacedParamsCache``) has no meaning on one device and waits for
multi-device planning (ROADMAP.md, queue 1, item 4).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.session import resolve_device
from repro_torch.models.model import Model, stages_of


def _attn_cache_entry(cfg, kind: str, batch: int, cache_len: int, device: torch.device):
    dt = getattr(torch, cfg.dtype)

    def kv():
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd())
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    if kind in ("attn", "moe"):
        return {"kv": kv()}
    if kind == "mamba1":
        c = cfg.ssm_expand * cfg.d_model
        return {
            "ssm1": {
                "conv": torch.zeros(
                    (batch, cfg.conv_width - 1, c), dtype=dt, device=device
                ),
                "ssm": torch.zeros((batch, c, cfg.ssm_state), dtype=torch.float32, device=device),
            }
        }
    if kind in ("mamba2", "mamba2_attn"):
        c = cfg.ssm_expand * cfg.d_model
        entry = {
            "ssm2": {
                "conv": torch.zeros(
                    (batch, cfg.conv_width - 1, c + 2 * cfg.ssm_state), dtype=dt, device=device
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
    raise NotImplementedError(
        f"the cache of block kind {kind!r} is not ported yet: the port builds "
        "attn, moe, mamba1, mamba2 and mamba2_attn (ROADMAP.md, queue 1, item 6.4: "
        "local/global, mla, enc/dec)"
    )


def init_cache(cfg, batch: int, cache_len: int, device=None):
    """Zero-initialized caches in ``Model``'s layout, on ``device`` ("cuda"
    unless the caller passes another). ``cache_len`` sizes attention caches."""
    dev = resolve_device(device, owner="repro_torch.serving.init_cache")
    caches = []
    for st in stages_of(cfg):
        scan = [
            {f"{i}:{kind}": _attn_cache_entry(cfg, kind, batch, cache_len, dev) for i, kind in enumerate(st.pattern)}
            for _ in range(st.repeats)
        ]
        tail = [_attn_cache_entry(cfg, kind, batch, cache_len, dev) for kind in st.tail]
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


def make_prefill_step(model: Model, cache_len: int, *, db=None):
    """``prefill_step(batch, params=None) → (logits (B,1,V), caches)``
    without autograd. ``params`` is what ``Model.prefill`` takes (None: the
    module's own tensors). ``db`` (a ``repro_torch.Database``) is the
    session the step runs under — its dispatch table picks the kernels —
    else the ambient one; ``BucketedPrefill`` is the bucketed front end
    over this."""

    def prefill_step(batch, params=None):
        with _session(db), torch.inference_mode():
            return model.prefill(batch, cache_len, params=params)

    return prefill_step


def make_decode_step(model: Model, *, db=None, on_trace: Optional[Callable[[], None]] = None):
    """``decode_step(token, caches, length, params=None) → (logits (B,1,V),
    caches)`` without autograd; ``params`` and ``db`` as in
    ``make_prefill_step``. ``on_trace`` (internal; the serving telemetry
    hook) is called at the step's first call: where the reference counts
    a jit trace per shape class, an eager step has one first call, and
    the serving front door builds one step per batch bucket."""
    traced = False

    def decode_step(token, caches, length, params=None):
        nonlocal traced
        if on_trace is not None and not traced:
            traced = True
            on_trace()
        with _session(db), torch.inference_mode():
            return model.decode_step(token, caches, length, params=params)

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
    bound.

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
        on_compile: Optional[Callable[[], None]] = None,
    ):
        if db is None:
            from repro_torch.core.session import Database

            db = Database(device, max_cache_entries=max_entries)
        self.db = db
        self.model = model
        self.cache_len = cache_len
        self.buckets: Optional[List[Tuple[int, int]]] = (
            sorted({(int(b), int(s)) for b, s in buckets}) if buckets else None
        )
        #: telemetry hook: called once per bucket step built (a
        #: session-cache miss) — the endpoint counts these under
        #: ``serve/prefill/compiles``.
        self.on_compile = on_compile

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
        key = ("prefill", id(self.model), self.cache_len, bucket)

        def build():
            if self.on_compile is not None:
                self.on_compile()
            return make_prefill_step(self.model, self.cache_len, db=self.db)

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

    def warmup(self, params, *, buckets=None) -> None:
        """Run the given (default: all configured) buckets' steps once,
        on a zero token batch on the session's device, before traffic
        arrives."""
        todo = buckets if buckets is not None else (self.buckets or ())
        for b, s in todo:
            step = self._compiled((int(b), int(s)))
            step({"tokens": torch.zeros((int(b), int(s)), dtype=torch.int32,
                                        device=self.db.device)}, params)
        if self.db.device.type == "cuda":
            torch.cuda.synchronize(self.db.device)
