"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144.  5:1 local:global (window=1024), 128k.  head_dim=256 per the
real gemma-3-12b (16 heads × 256 = 4096 ≠ d_model).  long_500k runs.
[hf:google/gemma-3-1b-pt; unverified]

The JAX package's numbers, no more: no qk-norm, no separate local RoPE
base and no soft-capping (the reference has none of them).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma3-12b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    attn_pattern="local_global",
    window=1024,
    local_per_global=5,
    rope_theta=1_000_000.0,
    max_seq_len=131072,
    tie_embeddings=True,
)
