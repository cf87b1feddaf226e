"""granite-3-8b [dense] — 40L d_model=4096 32H (GQA kv=8) d_ff=12800
vocab=49155.  Pure full attention → long_500k is skipped (DESIGN §3).
[hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "granite-3-8b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    attn_pattern="full",
    rope_theta=10000.0,
    max_seq_len=131072,
)
