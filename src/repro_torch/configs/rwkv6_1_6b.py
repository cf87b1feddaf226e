"""rwkv6-1.6b [ssm] — "Finch": 24L d_model=2048 (attention-free)
d_ff=7168 vocab=65536.  Data-dependent per-channel decay linear attention;
O(1) decode state → long_500k runs.  Heads are d_model/64 = 32.
[arXiv:2404.05892; unverified]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "rwkv6-1.6b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="rwkv",
    n_layers=24,
    d_model=2048,
    n_heads=32,                  # d_model / RWKV_HEAD_DIM(64)
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    attn_pattern="full",         # unused by the rwkv layout
    max_seq_len=1_048_576,
    # the JAX config's training knob, kept as data (the port serves)
    seq_shard_train=True,
)
