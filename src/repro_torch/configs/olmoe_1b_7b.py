"""olmoe-1b-7b [moe] — 64 experts, top-8, 1B active / 7B total
[arXiv:2409.02060]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,                 # per-expert FFN hidden
    vocab=50304,
    pattern=("moe",),
    n_experts=64,
    top_k=8,
    rope_theta=10_000.0,
    qk_norm=True,              # OLMoE uses QK-norm
)
