"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8 experts top-2, no shared experts.  Pure full attention.
The moment, gradient-accumulation and sequence-sharding fields are the JAX
package's training settings, kept as data; nothing in this package reads
them.
[hf:xai-org/grok-1; unverified]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "grok-1-314b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    n_experts=8,
    top_k=2,
    moe_d_ff=32768,
    n_shared_experts=0,
    capacity_factor=1.25,
    attn_pattern="full",
    rope_theta=10000.0,
    max_seq_len=8192,
    moment_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    seq_shard_train=True,
)
