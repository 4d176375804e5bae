"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed experts top-8,
first 3 layers dense [arXiv:2412.19437].

MTP (multi-token prediction) head omitted — noted in DESIGN.md; the MLA
decode path uses the absorbed low-rank formulation so the cache stores
only (c_kv 512 + k_rope 64) per position.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                # dense-layer FFN hidden
    d_expert_ff=2048,          # routed-expert hidden
    vocab=129280,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    first_k_dense=3,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    rope_theta=10_000.0,
    opt_state_dtype="bfloat16",
)
