"""llava-next-34b [vlm] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000.  Yi-34B-style language backbone; the anyres vision tiling is a
stub: the caller gives precomputed patch embeddings (B, 576, d) for one
base tile as ``batch["frontend_embeddings"]``, prepended to the text.  The
56 query heads are padded to 64 (``pad_heads_to``), as in the JAX package,
whose sharding grid wanted it; the port keeps the padding so that both
packages hold the same weights (8 query heads of random weights more, ~14%
more attention work).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "llava-next-34b"

CONFIG = ModelConfig(
    name=ARCH_ID,
    layout="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attn_pattern="full",
    frontend="vision",
    n_frontend_tokens=576,       # one anyres base tile of CLIP patches
    pad_heads_to=64,             # 56 → 64 query heads, as the JAX package
    rope_theta=5_000_000.0,
    max_seq_len=131072,
)
