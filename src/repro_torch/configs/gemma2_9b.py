"""gemma2-9b [dense] — alternating local(4096)/global attention, attn
logit softcap 50, final logit softcap 30 [arXiv:2408.00118]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    arch_type="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    d_ff=14336,
    vocab=256000,
    head_dim=256,
    pattern=("local", "global"),
    window=4096,
    logit_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
)
