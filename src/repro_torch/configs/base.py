"""Architecture configuration schema + the four assigned input shapes.

A copy of the reference's ``repro/configs/base.py`` with the same field
names, so a configuration crosses between the packages one to one. In this
package ``ssm_pallas=True`` selects the hand-written CUDA selective-scan
kernel (``kernels/ssm_scan``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 10_000.0

    # attention pattern: repeating superblock of layer kinds; remainder
    # layers (n_layers % len(pattern)) are emitted unscanned at the end.
    pattern: Tuple[str, ...] = ("attn",)
    window: Optional[int] = None       # sliding window for "local" layers
    logit_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qk_norm: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0             # deepseek-v3: leading dense layers
    capacity_factor: float = 1.25
    d_expert_ff: int = 0               # routed-expert hidden (if ≠ d_ff)
    moe_shard_experts: bool = False    # force expert-buffer sharding hints
                                       # (measured worse in §Perf; optional)

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0

    # SSM
    ssm_state: int = 0
    mamba_version: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    conv_width: int = 4
    ssm_chunk: int = 0                 # >0: sequential scan over chunks of
                                       # this length (parallel prefix within)
    ssm_scan_dtype: str = "float32"    # state dtype inside the scan
    ssm_pallas: bool = False           # use the single-pass scan kernel
                                       # (CUDA on the card; its plain
                                       # version on the CPU)

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    enc_seq: int = 0

    # VLM (qwen2-vl)
    mrope_sections: Tuple[int, int, int] = ()
    vis_seq: int = 0

    # numerics / execution
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False          # gemma: embeddings × sqrt(d_model)
    remat: bool = True
    remat_policy: str = "nothing"      # nothing | dots — what remat saves:
                                       # "dots" keeps matmul outputs (less
                                       # backward recompute, more live bytes)
    attn_chunk: int = 2048             # online-softmax KV block for prefill
    opt_state_dtype: str = "float32"   # bf16 for the largest configs
    scan_unroll: int = 1               # dry-run sets repeats (full unroll) so
                                       # cost_analysis counts loop bodies ×trip

    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self, **overrides) -> "ModelConfig":
        """Reduced same-family variant for CPU smoke tests: ≤2 superblocks,
        d_model≤256, ≤4 experts, small vocab."""
        small = dict(
            n_layers=min(self.n_layers, 2 * max(1, len(self.pattern))),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            head_dim=64 if self.head_dim else None,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            first_k_dense=min(self.first_k_dense, 1),
            q_lora_rank=min(self.q_lora_rank, 32),
            kv_lora_rank=min(self.kv_lora_rank, 32),
            rope_head_dim=min(self.rope_head_dim, 16),
            nope_head_dim=min(self.nope_head_dim, 32),
            v_head_dim=min(self.v_head_dim, 32),
            encoder_layers=min(self.encoder_layers, 2),
            enc_seq=min(self.enc_seq, 16),
            vis_seq=min(self.vis_seq, 8),
            window=min(self.window, 16) if self.window else None,
            attn_chunk=16,
            dtype="float32",
            remat=False,
        )
        if self.n_kv_heads:
            small["n_kv_heads"] = max(1, min(self.n_kv_heads, 2))
        small.update(overrides)
        return replace(self, **small)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
