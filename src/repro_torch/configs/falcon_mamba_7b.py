"""falcon-mamba-7b [ssm] — attention-free Mamba-1, state 16
[arXiv:2410.05355]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=65024,
    pattern=("mamba1",),
    ssm_state=16,
    mamba_version=1,
    ssm_expand=2,
    conv_width=4,
)
