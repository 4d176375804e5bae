"""qwen2-vl-72b [vlm] — M-RoPE (t/h/w sections), dynamic-resolution ViT
frontend is a STUB per assignment (input_specs provides patch embeddings)
[arXiv:2409.12191]."""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    arch_type="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    pattern=("attn",),
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # frequency pairs per t/h/w axis (hd=128)
    vis_seq=256,
    opt_state_dtype="bfloat16",
)
