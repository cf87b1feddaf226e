"""zamba2-7b [hybrid] — 81L d_model=3584 32H (GQA kv=32) d_ff=14336
vocab=32000, ssm_state=64.  Mamba2 backbone with a *shared* full-attention
block applied every ``attn_every`` layers (same weights at every site, per
the Zamba2 design).  SSM state carries long context → long_500k runs.
[arXiv:2411.15242; unverified]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "zamba2-7b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="mamba_hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    attn_every=6,                # shared attention block every 6 mamba layers
    attn_pattern="full",
    rope_theta=10000.0,
    max_seq_len=1_048_576,
)
