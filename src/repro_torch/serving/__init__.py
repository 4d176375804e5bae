"""Serving: batched prefill and single-token decode steps (serve.py), the
bucketed prefill engine, and the async serving front door (service.py)."""

from .serve import (  # noqa: F401
    BucketedPrefill,
    init_cache,
    make_decode_step,
    make_encode_step,
    make_prefill_step,
    move_cache_rows,
)
from .service import (  # noqa: F401
    Completion,
    DeadlineExceeded,
    Endpoint,
    EndpointClosed,
    Overloaded,
    ServingError,
    serve,
)
