"""whisper-small [audio] — encoder-decoder; the mel + conv frontend is a
STUB per assignment (input_specs provides precomputed frame embeddings
(B, 1500, 768)) [arXiv:2212.04356].

Deviations noted in DESIGN.md: rotary instead of learned positions;
decode_32k uses a synthetic 32k decoder cache (the real decoder caps at
448 positions).
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    arch_type="audio",
    n_layers=12,               # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    pattern=("dec",),
    encoder_layers=12,
    enc_seq=1500,
    tie_embeddings=True,       # whisper ties decoder embed/unembed
)
