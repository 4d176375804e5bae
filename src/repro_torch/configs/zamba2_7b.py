"""zamba2-7b [hybrid] — Mamba-2 backbone with a *shared* attention+MLP
block interleaved (one parameter set reused at every attention position)
[arXiv:2411.15242]. 81 layers = 13 × (5 mamba2 + 1 mamba2+shared-attn) + 3."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "mamba2_attn"),
    ssm_state=64,
    mamba_version=2,
    ssm_expand=2,
    ssm_head_dim=64,
    conv_width=4,
)
