"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144.  5:1 local:global attention (window=1024 local layers), 128k
context.  head_dim=128 per the real gemma-3 family (q_dim ≠ d_model; the
12b has 256).
[hf:google/gemma-3-1b-pt; unverified]

The JAX package's numbers, no more: no qk-norm, no separate local RoPE
base and no soft-capping (the reference has none of them).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma3-27b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    attn_pattern="local_global",
    window=1024,
    local_per_global=5,
    rope_theta=1_000_000.0,
    max_seq_len=131072,
    tie_embeddings=True,
)
