"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60 routed experts top-4 + 4 shared experts.  Pure full
attention → long_500k skipped.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2-moe-a2.7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    top_k=4,
    moe_d_ff=1408,
    n_shared_experts=4,
    capacity_factor=1.25,
    attn_pattern="full",
    rope_theta=1_000_000.0,
    max_seq_len=32768,
)
