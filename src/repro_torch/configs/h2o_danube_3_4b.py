"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000.  Llama+Mistral mix with sliding-window attention (window=4096)
→ sub-quadratic → long_500k runs.  head_dim = 3840/32 = 120 (as in the real
danube family; not 128-aligned — noted in EXPERIMENTS §Roofline).
[arXiv:2401.16818; unverified]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "h2o-danube-3-4b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    attn_pattern="swa",
    window=4096,
    rope_theta=10000.0,
    max_seq_len=131072,
)
