"""deepseek-coder-33b [dense] — llama-architecture code model
[arXiv:2401.14196]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab=32256,
    pattern=("attn",),
    rope_theta=100_000.0,
)
