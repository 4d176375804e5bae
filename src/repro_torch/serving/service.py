"""The async serving front door: continuous batching over a Database.

The paper's systems pitch is that the relational engine *is* the ML
system — so the ``repro_torch.Database`` session front door must also be
the serving front door. ``Endpoint`` (built with ``db.endpoint(...)`` /
``repro_torch.serve(db, ...)``) is that service layer:

  * an **admission queue** (bounded at ``max_queue``; overflow requests
    are shed with ``Overloaded``, counted under
    ``db.counters()["serve"]["shed_queue_full"]``),
  * **continuous batching**: a scheduler task coalesces whatever
    requests are in flight — grouped by (model version, prompt length) —
    into the session's (batch, seq) **bucketed prefill steps**
    (serve.py's ``BucketedPrefill``), so N concurrent single-row
    requests cost ~N/bucket prefill steps, not N,
  * **decode-step bucketing with slot reuse**: decode runs at a small
    set of batch buckets (one step built per bucket, never per exact
    batch); a finished request releases its slot immediately — its
    future resolves mid-group — and when enough slots free up the group
    compacts down to a smaller bucket (``decode/rebuckets``),
  * **per-tenant model versions** resolved through the catalog's model
    registry (``db.register_model``): requests address models as
    ``name@version`` or through the endpoint's tenant map, and
    re-registering a version hot-swaps the served parameters,
  * **deadline shedding**: a request whose deadline passes while queued
    is rejected at batch formation (``DeadlineExceeded``,
    ``serve/shed_deadline``) instead of wasting a slot.

Every counter lives in the session's telemetry tree next to the cache
and spill counters::

    db.counters()["serve"]   # requests, batches, sheds, prefill/decode

Quickstart::

    db = repro_torch.Database()                     # runs on "cuda"
    db.register_model("lm", model, dict(model.named_parameters()))  # → lm@v1
    ep = db.endpoint("lm", cache_len=48,
                     buckets=[(1, 16), (4, 16), (8, 16)])
    ep.warmup()                                     # build before traffic

    async def client(prompt):
        out = await ep.submit(prompt, max_new_tokens=8)
        return out.token_ids

The sequence dim is never padded (see ``BucketedPrefill``): prompts must
arrive at a bucketed length. Tokens are decoded greedily (argmax). The
endpoint runs on its session's device: each batch's prompts go there
once, every step runs under ``db.activate()`` (the scheduler task may run
in another context than the caller's), and each decode step reads its
argmax row back, one synchronise a step.

Encoder-decoder and vision models (whisper, qwen2-vl) read more than
tokens: ``make_batch`` turns a group's (B, S) tokens into the prefill's
batch (adding ``frames`` or ``patches``). For whisper, the encoder's
output over the group's ``frames`` is computed once after the prefill,
padded to the decode bucket and compacted with the slots, and handed to
every decode step (``enc_out``); for qwen2-vl, decode starts at ``length =
seq + vis_seq``, the prompt's tokens and the patches before them, as the
reference's endpoint counts them.

On a mesh of several ranks (the session's ``db.mesh``) every rank builds
the same endpoint, each on its own session, and the steps run tensor- and
expert-parallel on each rank's shards. Rank 0 alone is the front door: it
admits the requests and makes every decision (batches, buckets, deadlines,
tenants and hot-swaps, EOS, compaction). Before each model step it
broadcasts a small header (the op — prefill, decode, compact or end —, the
entry key, the bucket; a prefill's batch, a compaction's rows, a decode
step's fed tokens), and the other ranks run ``Endpoint.follow()``: each
waits for the next header, runs the same step on its own session and
caches, and returns on the "end" that ``aclose()`` sends. Rank 0's tokens
are fed on every rank, so the ranks cannot fall out of step where an argmax
is a tie. A follower waits ``follow_timeout`` seconds at most for a header,
then raises ``FollowTimeout``; while rank 0's scheduler waits for requests
it sends an "idle" header every ``follow_timeout / 2`` seconds, so the wait
detects a leader that stopped, not a quiet one (before rank 0's first
request, and between its event loops, no scheduler runs: the wait bounds
those too). One method, ``_step``, runs each header's model step on every
rank; rank 0 announces the header and calls it, a follower receives the
header and calls it. PyTorch runs a process per rank where the
reference's JAX runs one process for every device; ``follow()`` is the one
addition that makes. A follower resolves each header's model by its
``(name, version)`` in its own registry, so every rank registers the
versions the endpoint serves.
"""

from __future__ import annotations

import asyncio
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .serve import BucketedPrefill, make_decode_step, make_encode_step, map_cache, pad_rows


class ServingError(RuntimeError):
    """Base class of the serving front door's structured failures."""


class Overloaded(ServingError):
    """The admission queue is at ``max_queue``: the request was shed at
    submit time (``serve/shed_queue_full``). Back off and retry."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before service started: it was shed
    at batch formation (``serve/shed_deadline``)."""


class EndpointClosed(ServingError):
    """The endpoint was closed; in-queue requests fail with this."""


class FollowTimeout(ServingError):
    """A follower (``Endpoint.follow``) waited its ``follow_timeout`` for
    rank 0's next header and none came."""


@dataclass
class Completion:
    """One served request's result."""

    #: greedily decoded token ids, ``(n_generated,)`` int32.
    token_ids: np.ndarray
    #: prompt length the request arrived with.
    prompt_len: int
    #: the catalog coordinate that served it, ``"name@version"``.
    model: str
    #: submit → completion wall time in seconds (event-loop clock).
    latency: float


@dataclass
class _Request:
    tokens: np.ndarray
    entry_key: Tuple[str, str]
    model_id: str
    seq: int
    max_new: int
    deadline: Optional[float]
    t_submit: float
    future: "asyncio.Future"
    generated: List[int] = field(default_factory=list)


@dataclass
class _Group:
    """A decode group's model state on one rank: the entry it runs, its
    decode bucket, the position it decodes next, and its caches and (enc/dec)
    encoder output, both ``bucket`` rows."""

    entry: Any
    bucket: int
    length: int
    caches: Any
    enc_out: Optional[torch.Tensor]


# -- cache-tree batch-dim surgery (decode slot pool) ------------------------
#
# The batch axis is 0 in every leaf of the port's cache layout (serve.py's
# module docstring); leaves without the expected extent there pass through.


def _pad_cache_batch(caches, bsz: int, bucket_b: int):
    """Zero-pad the cache tree's batch axis from ``bsz`` to the decode
    bucket ``bucket_b`` (the padded rows are dead slots)."""
    if bsz == bucket_b:
        return caches
    return map_cache(
        lambda t: pad_rows(t, bucket_b) if t.dim() and t.shape[0] == bsz else t, caches
    )


def _take_cache_batch(caches, idx: Sequence[int], bucket_b: int):
    """Gather cache rows ``idx`` out of a ``bucket_b``-batch cache tree —
    the slot-compaction move when a decode group re-buckets down."""
    idx = list(idx)
    return map_cache(lambda t: t[idx] if t.dim() and t.shape[0] == bucket_b else t, caches)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _decode_inputs(entry, db, batch, seq: int):
    """(whisper's encoder output over the batch's ``frames`` or None, the
    decode's first ``length``: ``seq`` plus the config's ``vis_seq``)."""
    cfg = getattr(entry.model, "cfg", None)
    enc_out = None
    if cfg is not None and getattr(cfg, "encoder_layers", 0) and "frames" in batch:
        enc_out = make_encode_step(entry.model, db=db)(batch["frames"], entry.params)
    vis = int(getattr(cfg, "vis_seq", 0) or 0) if cfg is not None else 0
    return enc_out, seq + vis


class Endpoint:
    """An async serving endpoint over a ``repro_torch.Database`` session.

    Construct through ``db.endpoint(model, ...)`` (or
    ``repro_torch.serve``). ``model`` is a registered model name (``"lm"``
    / ``"lm@v2"``), a Model instance (auto-registered under ``name=`` with
    ``params=``), or None (every request must then pass ``model=`` /
    ``tenant=``).

    Parameters
    ----------
    cache_len:
        KV/state cache length decode runs against (prompt + generation
        budget; one decode step per batch bucket).
    buckets:
        (batch, seq) prefill buckets, as in ``BucketedPrefill``. None
        builds a step per exact shape (coalescing still happens,
        bucketing does not).
    decode_buckets:
        batch buckets decode runs at. Default: powers of two up to the
        largest prefill bucket batch; None (with ``buckets=None``)
        decodes at exact batch.
    tenants:
        tenant → ``"name[@version]"`` model-registry coordinates;
        ``submit(tenant=...)`` resolves through this map, so tenants pin
        model versions without clients knowing the mapping.
    max_queue:
        admission queue bound; a full queue sheds with ``Overloaded``.
        None = unbounded (no queue-full shedding). The scheduler batches
        what is already in flight when it forms a batch: requests queue
        while a batch decodes.
    gather_window:
        seconds the scheduler waits after the first queued request for
        more to coalesce with. 0 (default) batches only what is already
        in flight — under sustained load that is plenty.
    max_new_tokens:
        per-request default generation budget.
    eos_token:
        optional end-of-sequence token id: a slot whose latest generated
        token equals it is released immediately (counted on
        ``counters["serve"]["decode"]["eos_stops"]``) instead of
        decoding to its ``max_new_tokens`` budget. None (default)
        disables early stop.
    make_batch:
        optional ``tokens (B, S) → batch dict`` hook for models whose
        prefill reads more than ``{"tokens": ...}`` (whisper's ``frames``,
        qwen2-vl's ``patches``).
    follow_timeout:
        on a mesh of several ranks, the seconds a follower waits for rank
        0's next header before it raises ``FollowTimeout`` (module
        docstring); rank 0's scheduler sends an "idle" header every half
        of it while no request comes.

    A session with a mesh serves through the steps on that mesh
    (``serve.make_prefill_step(mesh=)``). On a mesh of several ranks every
    rank builds the endpoint at the same point of its program (that makes
    its header group); rank 0 serves and the others call ``follow()``.
    The mesh's data axes must be of size 1: the decode slot pool moves
    whole-batch cache rows, and a rank holds all of them only there.
    """

    def __init__(
        self,
        db,
        model=None,
        *,
        cache_len: int,
        params=None,
        version: Optional[str] = None,
        name: Optional[str] = None,
        buckets: Optional[Sequence[Tuple[int, int]]] = None,
        decode_buckets: Optional[Sequence[int]] = None,
        tenants: Optional[Dict[str, str]] = None,
        max_queue: Optional[int] = 64,
        gather_window: float = 0.0,
        max_new_tokens: int = 16,
        eos_token: Optional[int] = None,
        make_batch: Optional[Callable[[torch.Tensor], Dict[str, Any]]] = None,
        follow_timeout: float = 600.0,
    ):
        self.db = db
        #: on a mesh of several ranks: the mesh's collectives, the group
        #: the headers go over and this rank's index (0 serves)
        self._comm = self._headers = None
        self._position = 0
        self.follow_timeout = float(follow_timeout)
        mesh = db.mesh
        if mesh is not None and mesh.mesh.numel() > 1:
            self._join(mesh)
        self.cache_len = int(cache_len)
        self._buckets = (
            sorted({(int(b), int(s)) for b, s in buckets}) if buckets else None
        )
        if decode_buckets is not None:
            self.decode_buckets: Optional[List[int]] = sorted(
                {int(b) for b in decode_buckets}
            )
        elif self._buckets:
            top = _next_pow2(max(b for b, _ in self._buckets))
            self.decode_buckets = [
                2 ** i for i in range(top.bit_length()) if 2 ** i <= top
            ]
        else:
            self.decode_buckets = None
        self._tenants = dict(tenants or {})
        self._max_queue = max_queue
        self._gather_window = float(gather_window)
        self._max_new_tokens = int(max_new_tokens)
        self._eos_token = None if eos_token is None else int(eos_token)
        self._make_batch = make_batch

        self._default: Optional[Tuple[str, Optional[str]]] = None
        if model is None:
            pass
        elif isinstance(model, str):
            entry = db.model(model, version)  # validates registration
            # "lm@v2" / version= pins that version; a bare name follows
            # the latest registration (hot-swap on re-register)
            pinned = version is not None or "@" in model
            self._default = (entry.name, entry.version if pinned else None)
        else:
            if params is None:
                raise ValueError(
                    "db.endpoint(model_instance) needs params=; or "
                    "db.register_model(name, model, params) first and "
                    "pass the name"
                )
            entry = db.register_model(
                name or "default", model, params, version=version
            )
            self._default = (entry.name, None)  # follows re-registrations

        #: one bucketing engine per (model name, version) served.
        self._prefills: Dict[Tuple[str, str], BucketedPrefill] = {}
        self._serve = db._counters["serve"]
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._queue: Optional[asyncio.Queue] = None
        self._closed = False

    # -- several ranks: rank 0 leads, the others follow ---------------------

    def _join(self, mesh) -> None:
        """Make this endpoint's header group over the mesh's ranks (every
        rank makes it, at once: ``new_group`` is collective)."""
        import datetime

        import torch.distributed as dist

        from repro_torch.core.planner import MeshGeometry
        from repro_torch.launch.collectives import comm_for
        from repro_torch.launch.mesh import data_parallel_size

        if data_parallel_size(mesh) > 1:
            raise NotImplementedError(
                "an endpoint over several ranks needs a mesh whose data axes are of size "
                "1 (e.g. make_host_mesh(model=n)): its decode slot pool moves whole-batch "
                "cache rows, which a rank holds whole only there (ROADMAP.md)")
        self._comm = comm_for(mesh, MeshGeometry.from_mesh(mesh))
        self._position = self._comm.position
        self._headers = dist.new_group(
            sorted(self._comm.ranks), backend="gloo",
            timeout=datetime.timedelta(seconds=self.follow_timeout))

    @property
    def leads(self) -> bool:
        """True on the rank that serves (rank 0 of the mesh, or the one
        process off a mesh); False on a follower."""
        return self._position == 0

    def _announce(self, header: Dict[str, Any], batch: Optional[Dict[str, Any]] = None) -> None:
        """Rank 0: send the next step's ``header`` (and ``batch``, its
        tensors broadcast over the mesh) to the followers; a no-op off a
        mesh of several ranks."""
        if self._headers is None:
            return
        from repro_torch.launch import collectives

        tensors = {}
        if batch is not None:
            tensors = {k: v for k, v in batch.items() if isinstance(v, torch.Tensor)}
            header = dict(header,
                          tensors=[(k, tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tensors.items()],
                          extras={k: v for k, v in batch.items() if k not in tensors})
        collectives.broadcast_object(header, self._comm, group=self._headers)
        for v in tensors.values():
            collectives.broadcast(v.contiguous(), self._comm)

    def _receive(self) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]]]:
        """A follower: rank 0's next header and its batch (None without)."""
        from repro_torch.launch import collectives

        try:
            header = collectives.broadcast_object(None, self._comm, group=self._headers)
        except RuntimeError as e:
            raise FollowTimeout(
                f"rank {self._position} of the endpoint's mesh waited {self.follow_timeout:g} s "
                f"for rank 0's next step header and none came ({e})") from e
        if "tensors" not in header:
            return header, None
        batch = {}
        for k, shape, dtype in header["tensors"]:
            t = torch.empty(shape, dtype=getattr(torch, dtype), device=self.db.device)
            batch[k] = collectives.broadcast(t, self._comm)
        batch.update(header["extras"])
        return header, batch

    def _leave(self) -> None:
        """Destroy this endpoint's header group (on every rank that ends)."""
        import torch.distributed as dist

        if self._headers is not None:
            dist.destroy_process_group(self._headers)
            self._headers = None

    def follow(self) -> Dict[str, int]:
        """Run, on a rank other than 0, the steps rank 0 announces: each
        header's step (``_step``: a prefill, compaction or decode step,
        warmup's builds) on this rank's session and caches, feeding rank
        0's tokens. Returns on the "end" header that rank 0's ``aclose()``
        sends, with the count of each op run (and of "idle" headers, and of
        steps that raised, as rank 0's scheduler serves on past a failed
        group); raises ``FollowTimeout`` when no header comes within
        ``follow_timeout`` seconds."""
        if self._comm is None or self.leads:
            raise ValueError("follow() runs on a rank other than 0 of an endpoint over several ranks; "
                             "rank 0 serves (submit, warmup, aclose)")
        if self._headers is None:
            raise EndpointClosed("the endpoint is closed: its followers have left")
        done: Dict[str, int] = {"prefill": 0, "compact": 0, "decode": 0, "warm_prefill": 0,
                                "warm_decode": 0, "idle": 0, "failed": 0}
        group: Optional[_Group] = None
        try:
            while True:
                header, batch = self._receive()
                op = header["op"]
                if op == "end":
                    return done
                if op != "idle":
                    try:
                        _, group = self._step(header, batch, group)
                    except ServingError:
                        raise
                    except Exception:
                        # rank 0's same step raised too: it fails the
                        # group's requests and serves on, so this rank
                        # follows on
                        done["failed"] += 1
                        warnings.warn(f"rank {self._position}: a {op!r} step raised; following on:\n"
                                      f"{traceback.format_exc()}", RuntimeWarning, stacklevel=2)
                        continue
                done[op] += 1
        finally:
            self._leave()

    def _lead(self, header: Dict[str, Any], batch: Optional[Dict[str, Any]] = None,
              group: Optional[_Group] = None) -> Tuple[Optional[torch.Tensor], Optional[_Group]]:
        """Rank 0: announce ``header`` (and ``batch``) to the followers, then
        run its step here."""
        self._announce(header, batch)
        return self._step(header, batch, group)

    def _step(self, header: Dict[str, Any], batch: Optional[Dict[str, Any]],
              group: Optional[_Group]) -> Tuple[Optional[torch.Tensor], Optional[_Group]]:
        """Run the model step ``header`` names on this rank's session and
        caches, as every rank runs it: "prefill" (``batch``; a new group of
        ``header["bucket"]`` rows), "compact" (the group's rows
        ``header["idx"]`` into the smaller bucket), "decode" (one step fed
        ``header["tok"]``), "warm_prefill" and "warm_decode" (warmup's
        builds). Returns the step's logits (None where it has none) and the
        group."""
        c = self._serve
        op = header["op"]
        if op == "prefill":
            entry = self.db.model(*header["entry"])
            logits, caches = self._prefill_for(entry).prefill(entry.params, batch)
            c["batches"] += 1
            c["prefill"]["steps"] += 1
            enc_out, length = _decode_inputs(entry, self.db, batch, header["seq"])
            k, bucket = int(batch["tokens"].shape[0]), int(header["bucket"])
            return logits, _Group(entry, bucket, length, _pad_cache_batch(caches, k, bucket),
                                  None if enc_out is None else pad_rows(enc_out, bucket))
        if op == "compact":
            idx = header["idx"]
            group.caches = _take_cache_batch(group.caches, idx, group.bucket)
            if group.enc_out is not None:
                group.enc_out = group.enc_out[idx]
            group.bucket = int(header["bucket"])
            c["decode"]["rebuckets"] += 1
            return None, group
        if op == "decode":
            if (tuple(header["entry"]), header["bucket"], header["length"]) != (
                    group.entry.key, group.bucket, group.length):
                raise ServingError(f"rank {self._position} is out of step with rank 0: header "
                                   f"{header['entry']}, bucket {header['bucket']}, length "
                                   f"{header['length']}; this rank's group {group.entry.key}, "
                                   f"{group.bucket}, {group.length}")
            tok = torch.tensor(header["tok"], dtype=torch.int32, device=self.db.device)[:, None]
            step = self._decode_exec(group.entry, group.bucket)
            logits, group.caches = step(tok, group.caches, group.length, group.entry.params,
                                        group.enc_out)
            group.length += 1
            c["decode"]["steps"] += 1
            return logits, group
        if op not in ("warm_prefill", "warm_decode"):
            raise ServingError(f"unknown step header op {op!r}")
        entry = self.db.model(*header["entry"])
        pre = self._prefill_for(entry)
        if op == "warm_prefill":
            pre.warmup(entry.params, buckets=[tuple(header["bucket"])], batch_fn=lambda b, s: batch)
        else:
            self._warm_decode(entry, pre, batch, header["seq"])
        return None, group

    # -- model resolution (through the catalog) ----------------------------

    def _resolve(self, *, tenant=None, model=None, version=None):
        if tenant is not None:
            if model is not None:
                raise ValueError("pass tenant= or model=, not both")
            try:
                spec = self._tenants[tenant]
            except KeyError:
                raise ValueError(
                    f"tenant {tenant!r} has no model mapping on this "
                    f"endpoint (tenants: {sorted(self._tenants)})"
                ) from None
            return self.db.model(spec)
        if model is not None:
            return self.db.model(model, version)
        if self._default is None:
            raise ValueError(
                "endpoint has no default model; pass model= (or tenant=) "
                "to submit, or model= to db.endpoint(...)"
            )
        return self.db.model(*self._default)

    def _prefill_for(self, entry) -> BucketedPrefill:
        pre = self._prefills.get(entry.key)
        if pre is None or pre.model is not entry.model:
            counters = self._serve["prefill"]

            def on_compile():
                counters["compiles"] += 1

            pre = BucketedPrefill(
                entry.model,
                self.cache_len,
                db=self.db,
                buckets=self._buckets,
                on_compile=on_compile,
            )
            self._prefills[entry.key] = pre
        return pre

    def _decode_exec(self, entry, bucket: int):
        dec = self._serve["decode"]
        key = ("decode", entry.key, id(entry.model), self.cache_len, bucket)

        def build():
            dec["compiles"] += 1

            def on_trace():
                dec["traces"] += 1

            return make_decode_step(entry.model, db=self.db, on_trace=on_trace)

        return self.db.cached_executable(key, build)

    def _decode_bucket(self, k: int) -> int:
        if not self.decode_buckets:
            return k
        fitting = [b for b in self.decode_buckets if b >= k]
        return min(fitting) if fitting else k

    # -- the request path ---------------------------------------------------

    async def submit(
        self,
        tokens,
        *,
        tenant: Optional[str] = None,
        model: Optional[str] = None,
        version: Optional[str] = None,
        max_new_tokens: Optional[int] = None,
        deadline: Optional[float] = None,
    ) -> Completion:
        """Serve one prompt (1-D int token ids) and return its
        ``Completion`` — admission, batching, prefill and decode all
        happen behind the await. ``deadline`` (seconds from now) sheds
        the request with ``DeadlineExceeded`` if service has not started
        in time; a full admission queue sheds immediately with
        ``Overloaded``."""
        if self._closed:
            raise EndpointClosed("endpoint is closed")
        if not self.leads:
            raise ValueError("rank 0 admits the requests of an endpoint over several ranks; "
                             "this rank runs follow()")
        c = self._serve
        c["requests"] += 1
        arr = np.asarray(tokens.cpu() if isinstance(tokens, torch.Tensor) else tokens)
        if arr.ndim != 1:
            raise ValueError(
                f"submit takes one prompt of 1-D token ids; got shape "
                f"{arr.shape} (batching is the endpoint's job)"
            )
        seq = int(arr.shape[0])
        if seq == 0:
            raise ValueError(
                "zero-length prompt: prefill needs at least one token — "
                "pad prompts to a configured bucket length upstream"
            )
        max_new = int(
            self._max_new_tokens if max_new_tokens is None else max_new_tokens
        )
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        entry = self._resolve(tenant=tenant, model=model, version=version)
        # reject unservable shapes before they occupy a queue slot
        self._prefill_for(entry).bucket_for(1, seq)
        self._ensure_started()
        loop = self._loop
        req = _Request(
            tokens=arr.astype(np.int32),
            entry_key=entry.key,
            model_id=str(entry),
            seq=seq,
            max_new=max_new,
            deadline=None if deadline is None else loop.time() + deadline,
            t_submit=loop.time(),
            future=loop.create_future(),
        )
        try:
            self._queue.put_nowait(req)
        except asyncio.QueueFull:
            c["shed_queue_full"] += 1
            raise Overloaded(
                f"admission queue full (max_queue={self._max_queue}); "
                f"request shed — back off and retry"
            ) from None
        c["admitted"] += 1
        c["queue_peak"] = max(c["queue_peak"], self._queue.qsize())
        return await req.future

    def _ensure_started(self) -> None:
        loop = asyncio.get_running_loop()
        if self._loop is not loop or self._task is None or self._task.done():
            # (re)bind to the current event loop: endpoints survive
            # consecutive asyncio.run() blocks (each run tears its loop
            # — and the scheduler task — down with it)
            self._loop = loop
            self._queue = (
                asyncio.Queue(maxsize=self._max_queue)
                if self._max_queue
                else asyncio.Queue()
            )
            self._task = loop.create_task(
                self._run(), name="repro-torch-endpoint-scheduler"
            )

    async def _next_request(self) -> _Request:
        """The queue's next request. On a mesh of several ranks rank 0
        sends the followers an "idle" header every ``follow_timeout / 2``
        seconds that it waits, so that their wait detects a stopped leader,
        not a quiet one."""
        if self._headers is None:
            return await self._queue.get()
        while True:
            try:
                return await asyncio.wait_for(self._queue.get(), self.follow_timeout / 2)
            except asyncio.TimeoutError:
                self._announce({"op": "idle"})

    async def _run(self) -> None:
        while True:
            batch = [await self._next_request()]
            if self._gather_window > 0:
                # let concurrent submitters land in the queue, so that
                # the batch coalesces them
                await asyncio.sleep(self._gather_window)
            while True:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            await self._dispatch(batch)

    async def _dispatch(self, batch: List[_Request]) -> None:
        c = self._serve
        now = self._loop.time()
        groups: Dict[Tuple[Tuple[str, str], int], List[_Request]] = {}
        for r in batch:
            if r.deadline is not None and now >= r.deadline:
                c["shed_deadline"] += 1
                if not r.future.done():
                    r.future.set_exception(
                        DeadlineExceeded(
                            f"deadline passed before service started "
                            f"(queued {now - r.t_submit:.3f}s)"
                        )
                    )
                continue
            groups.setdefault((r.entry_key, r.seq), []).append(r)
        for (entry_key, seq), reqs in groups.items():
            try:
                entry = self.db.model(*entry_key)  # fresh params (hot-swap)
                pre = self._prefill_for(entry)
                cap = pre.max_batch(seq) or len(reqs)
                chunks = [
                    reqs[i : i + cap] for i in range(0, len(reqs), cap)
                ]
            except Exception as e:  # keep the scheduler alive
                for r in reqs:
                    if not r.future.done():
                        c["failed"] += 1
                        r.future.set_exception(e)
                continue
            for chunk in chunks:
                try:
                    await self._serve_group(entry, chunk, seq)
                except Exception as e:  # keep serving the other groups
                    for r in chunk:
                        if not r.future.done():
                            c["failed"] += 1
                            r.future.set_exception(e)

    async def _serve_group(self, entry, reqs: List[_Request], seq: int) -> None:
        """Prefill one coalesced batch, then decode it as a slot pool:
        bucket-shaped caches, per-request completion the step a request
        finishes, compaction to a smaller bucket when slots free up. Each
        model step goes through ``_lead`` (announced to the followers on a
        mesh of several ranks); this keeps the admission, the tokens and
        the slots."""
        c = self._serve
        k = len(reqs)
        tokens = torch.as_tensor(
            np.stack([r.tokens for r in reqs]), device=self.db.device
        )
        batch = self._make_batch(tokens) if self._make_batch is not None else {"tokens": tokens}
        bucket = self._decode_bucket(k)
        logits, group = self._lead({"op": "prefill", "entry": entry.key, "seq": seq, "bucket": bucket},
                                   batch)
        if k > 1:
            c["batched_requests"] += k
        # the repo's models emit last-position-only prefill logits
        # (B, 1, V); [:, -1:] also tolerates per-token stand-ins
        fed = logits[:, -1].argmax(-1).tolist()  # the tokens each step is fed
        for r, t in zip(reqs, fed):
            r.generated.append(t)
        fed += [0] * (bucket - k)
        slots: List[Optional[_Request]] = list(reqs) + [None] * (bucket - k)

        eos = self._eos_token
        while True:
            for i, r in enumerate(slots):
                if r is None:
                    continue
                # EOS early stop: the model ended the sequence, so the
                # slot frees now (and may trigger a rebucket below)
                # instead of burning decode steps to the max_new budget
                eos_hit = (
                    eos is not None
                    and r.generated
                    and r.generated[-1] == eos
                    and len(r.generated) < r.max_new
                )
                if eos_hit or len(r.generated) >= r.max_new:
                    self._complete(r)
                    slots[i] = None
                    c["decode"]["slot_releases"] += 1
                    if eos_hit:
                        c["decode"]["eos_stops"] += 1
            active = [i for i, r in enumerate(slots) if r is not None]
            if not active:
                return
            nb = self._decode_bucket(len(active))
            if nb < group.bucket:
                # compact live slots to the front and drop to the
                # smaller bucket's step (built once, reused)
                idx = (active + [active[0]] * (nb - len(active)))[:nb]
                self._lead({"op": "compact", "idx": idx, "bucket": nb}, group=group)
                fed = [fed[i] for i in idx]
                slots = [slots[i] for i in active] + [None] * (
                    nb - len(active)
                )
            # yield: concurrent submits land in the admission queue and
            # coalesce into the next batch while this group decodes
            await asyncio.sleep(0)
            logits, group = self._lead({"op": "decode", "entry": entry.key, "bucket": group.bucket,
                                        "length": group.length, "tok": fed}, group=group)
            fed = logits[:, 0].argmax(-1).tolist()  # the step's one read back
            for i, r in enumerate(slots):
                if r is not None:
                    r.generated.append(fed[i])

    def _complete(self, req: _Request) -> None:
        if req.future.done():
            return
        self._serve["completed"] += 1
        req.future.set_result(
            Completion(
                token_ids=np.asarray(req.generated, np.int32),
                prompt_len=req.seq,
                model=req.model_id,
                latency=self._loop.time() - req.t_submit,
            )
        )

    # -- warmup + lifecycle -------------------------------------------------

    def warmup(
        self,
        *,
        tenant: Optional[str] = None,
        model: Optional[str] = None,
        version: Optional[str] = None,
        buckets: Optional[Sequence[Tuple[int, int]]] = None,
        decode: bool = True,
        batch_fn: Optional[Callable[[int, int], Dict[str, Any]]] = None,
    ) -> None:
        """Build and run once the prefill buckets' steps and
        (``decode=True``) every decode bucket's before traffic arrives, so
        a warmed endpoint never builds a step on the request path —
        ``db.counters()["serve"]`` shows flat prefill/decode compile
        counts under traffic afterwards. ``batch_fn(batch, seq)`` builds
        the exemplar batch, as in ``BucketedPrefill.warmup``: a model that
        reads ``frames`` or ``patches`` needs it."""
        if not self.leads:
            raise ValueError("rank 0 warms an endpoint over several ranks up and broadcasts its "
                             "builds; this rank runs follow()")
        entry = self._resolve(tenant=tenant, model=model, version=version)
        todo = [
            (int(b), int(s))
            for b, s in (buckets if buckets is not None else (self._prefill_for(entry).buckets or ()))
        ]
        if not todo:
            return

        def exemplar(b: int, s: int) -> Dict[str, Any]:
            return (batch_fn(b, s) if batch_fn is not None else
                    {"tokens": torch.zeros((b, s), dtype=torch.int32, device=self.db.device)})

        for bucket in todo:
            self._lead({"op": "warm_prefill", "entry": entry.key, "bucket": bucket}, exemplar(*bucket))
        if decode:
            self._lead({"op": "warm_decode", "entry": entry.key, "seq": todo[0][1]}, exemplar(*todo[0]))

    def _warm_decode(self, entry, pre: BucketedPrefill, ex: Dict[str, Any], s0: int) -> None:
        """Build and run every decode bucket's step once, from a prefill
        of the exemplar batch ``ex``."""
        params = entry.params
        b0 = int(ex["tokens"].shape[0])
        _, caches = pre.prefill(params, ex)
        enc_out, length = _decode_inputs(entry, self.db, ex, s0)
        for db_ in self.decode_buckets or [b0]:
            if db_ >= b0:
                cb = _pad_cache_batch(caches, b0, db_)
                eb = None if enc_out is None else pad_rows(enc_out, db_)
            else:
                cb = _take_cache_batch(caches, list(range(db_)), b0)
                eb = None if enc_out is None else enc_out[:db_]
            tok = torch.zeros((db_, 1), dtype=torch.int32, device=self.db.device)
            step = self._decode_exec(entry, db_)
            step(tok, cb, length, params, eb)
        if self.db.device.type == "cuda":
            torch.cuda.synchronize(self.db.device)

    async def aclose(self) -> None:
        """Stop the scheduler and fail queued requests with
        ``EndpointClosed``; further submits are rejected. On a mesh of
        several ranks, rank 0 sends the followers the "end" header, on
        which ``follow()`` returns."""
        end = self.leads and self._headers is not None and not self._closed
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if end:
            self._announce({"op": "end"})
            self._leave()
        while self._queue is not None and not self._queue.empty():
            r = self._queue.get_nowait()
            if not r.future.done():
                r.future.set_exception(EndpointClosed("endpoint closed"))

    async def __aenter__(self) -> "Endpoint":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()


def serve(db, model=None, **kwargs) -> Endpoint:
    """``repro_torch.serve(db, "lm", cache_len=..., buckets=...)`` — the
    one-call serving front door; equivalent to ``db.endpoint(...)``."""
    return db.endpoint(model, **kwargs)
