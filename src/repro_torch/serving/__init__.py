"""Serving steps: batched prefill and single-token decode (serve.py)."""

from .serve import init_cache, make_decode_step, make_prefill_step  # noqa: F401
