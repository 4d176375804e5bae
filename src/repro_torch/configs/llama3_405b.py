"""llama3-405b [dense] — GQA kv=8, 128k vocab, 126 layers
[arXiv:2407.21783]. The Adam moments are bf16 (``opt_state_dtype``), as
in the reference's config, which sized that choice for its TPU pod; the
field is kept so that the configuration crosses between the packages one
to one."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    arch_type="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    pattern=("attn",),
    rope_theta=500_000.0,
    opt_state_dtype="bfloat16",
)
