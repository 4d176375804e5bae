"""gemma3-4b [dense] — 5:1 local:global attention, 1024-token sliding
window, 128k context [hf:google/gemma-3-1b-pt family].

A deviation kept from the reference's config: gemma3 uses rope_theta 1e6
for global and 1e4 for local layers; both packages use a single 1e6 base.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    arch_type="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
    embed_scale=True,
)
