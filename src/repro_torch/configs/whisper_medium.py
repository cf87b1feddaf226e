"""whisper-medium [audio] — enc-dec, 24L decoder (+24L encoder) d_model=1024
16H (kv=16, MHA) d_ff=4096 vocab=51865.  The conv mel frontend is a stub:
the caller gives precomputed frame embeddings (B, 1500, d) as
``batch["frames"]``, and the transformer backbone (encoder + causal decoder
with cross-attention, ``models/encdec.py``) is what runs.
[arXiv:2212.04356; unverified]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "whisper-medium"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    attn_pattern="full",
    frontend="audio",
    n_frontend_tokens=1500,      # 30 s of mel frames after conv stride 2
    rope_theta=10000.0,
    max_seq_len=65536,           # the JAX package's backbone cells; the
                                 # real decoder takes 448 tokens
    tie_embeddings=True,
)
