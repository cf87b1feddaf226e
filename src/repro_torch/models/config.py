"""Unified model configuration covering every architecture family.

One ``ModelConfig`` describes dense GQA transformers (full / sliding-window /
local:global interleaved attention), MoE, RWKV6, Mamba2 hybrids and
encoder-decoders — the JAX package's config language, copied as plain data.
The model code of this package serves the ``dense``, ``moe``, ``rwkv`` and
``mamba_hybrid`` layouts; ``encdec`` raises ``NotImplementedError`` where
model code would need it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

FULL_WINDOW = -1  # sentinel: attention window covering the whole sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    layout: str                       # dense | moe | rwkv | mamba_hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # --- attention pattern ---
    attn_pattern: str = "full"        # full | swa | local_global
    window: int = 4096                # sliding window size for swa/local layers
    local_per_global: int = 5         # local:global interleave ratio

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    n_shared_experts: int = 0
    capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0                # Mamba2 state dim
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 6               # hybrid: shared attn block after every N ssm layers

    # --- encoder-decoder / modality frontend ---
    n_encoder_layers: int = 0
    frontend: str = "none"            # none | audio | vision
    n_frontend_tokens: int = 0        # stub embedding count (audio frames / patches)

    # --- misc ---
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    max_seq_len: int = 131072
    tie_embeddings: bool = False
    dtype: str = "bfloat16"           # compute dtype
    param_dtype: str = "float32"      # storage dtype
    moment_dtype: str = "float32"     # Adam moment storage (bf16 for 314B grok)
    grad_accum_dtype: str = "float32" # microbatch grad accumulator (bf16 grok)
    seq_shard_train: bool = False     # sequence-parallel residual stream in
                                      # training (Korthikanti-style SP; grok)
    remat: bool = True
    attn_chunk: int = 512             # query-block size for chunked flash-ref attention

    # --- sharding policy knobs (see models/sharding.py) ---
    attn_shard: str = "heads"         # heads | sequence (when heads don't divide)
    pad_heads_to: int = 0             # round query heads up to the sharding
                                      # grid (llava: 56 -> 64 on a 16-wide
                                      # model axis); 0 = no padding
    kv_update: str = "dus"            # dus | where — decode-cache write strategy:
                                      # "where" (masked elementwise) is the only
                                      # gather-free form when S is sharded
    use_pallas: bool = False          # kernel switch: MoE gating, one-shot
                                      # prefill attention, the WKV / SSD
                                      # prefill scans and lockstep decode
                                      # attention through kernels/

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.layout in ("dense", "moe", "encdec") and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads must be a multiple of n_kv_heads")
        if self.layout == "moe" and (self.n_experts <= 0 or self.top_k <= 0):
            raise ValueError(f"{self.name}: moe layout needs n_experts/top_k")

    # -- derived ---------------------------------------------------------------

    @property
    def compute_heads(self) -> int:
        """Query heads actually computed/stored (TPU alignment padding)."""
        return self.pad_heads_to or self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_windows(self, seq_len: int) -> Tuple[int, ...]:
        """Per-layer attention window; unifies full/swa/local:global in one code
        path (window == seq_len ⇒ full attention)."""
        out = []
        for l in range(self.n_layers):
            if self.attn_pattern == "full":
                out.append(seq_len)
            elif self.attn_pattern == "swa":
                out.append(min(self.window, seq_len))
            elif self.attn_pattern == "local_global":
                # pattern unit: `local_per_global` local layers then 1 global
                is_global = (l % (self.local_per_global + 1)) == self.local_per_global
                out.append(seq_len if is_global else min(self.window, seq_len))
            else:
                raise ValueError(self.attn_pattern)
        return tuple(out)

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k is runnable (DESIGN §3 skip policy)."""
        if self.layout in ("rwkv", "mamba_hybrid"):
            return True
        return self.attn_pattern in ("swa", "local_global")

    # -- parameter counting (for MODEL_FLOPS = 6·N·D roofline ratio) -----------

    def param_count(self) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        embed = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.layout in ("dense", "moe", "encdec"):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            per_layer += attn + 2 * d  # + norms
        if self.layout == "dense" or self.layout == "encdec":
            per_layer += 3 * d * f     # SwiGLU
        elif self.layout == "moe":
            per_layer += self.n_experts * 3 * d * self.moe_d_ff
            per_layer += self.n_shared_experts * 3 * d * self.moe_d_ff
            per_layer += d * self.n_experts  # router
        elif self.layout == "rwkv":
            di = self.ssm_expand * d  # rwkv: d_ff channel-mix + time-mix proj
            per_layer += 4 * d * d + d * self.d_ff * 2 + 8 * d
        elif self.layout == "mamba_hybrid":
            di = self.ssm_expand * d
            per_layer += d * (2 * di + 2 * self.n_heads * 0)  # in_proj (x,z)
            per_layer += 2 * d * di + di * d + di * self.ssm_conv  # in/out/conv
            per_layer += di * 2  # dt, A params (per-head-ish, negligible)
        n = embed + self.n_layers * per_layer
        if self.layout == "mamba_hybrid":
            # one shared full attention block + its ffn
            n += 4 * d * self.n_heads * self.head_dim + 3 * d * f
        if self.layout == "encdec":
            # encoder stack + cross attention in decoder
            enc = self.n_encoder_layers * (4 * d * d + 3 * d * f + 2 * d)
            cross = self.n_layers * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
            n += enc + cross
        return int(n)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if self.layout != "moe":
            return self.param_count()
        d = self.d_model
        dense_part = self.param_count() - self.n_layers * (
            (self.n_experts - self.top_k) * 3 * d * self.moe_d_ff)
        return int(dense_part)

    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def torch_param_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)


def scaled_down(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced config of the same family for CPU smoke tests."""
    base = dict(
        n_layers=max(2, min(4, cfg.n_layers // 16)),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        max_seq_len=512,
        window=64,
        attn_chunk=64,
        n_frontend_tokens=min(cfg.n_frontend_tokens, 16) if cfg.n_frontend_tokens else 0,
        remat=False,
    )
    if cfg.layout == "moe":
        base.update(n_experts=min(cfg.n_experts, 8), top_k=min(cfg.top_k, 2),
                    moe_d_ff=64, n_shared_experts=min(cfg.n_shared_experts, 2))
    if cfg.layout in ("mamba_hybrid",):
        base.update(ssm_state=16, attn_every=2, n_layers=5)
    if cfg.layout == "encdec":
        base.update(n_encoder_layers=2)
    if cfg.layout == "rwkv":
        base.update(n_heads=4, head_dim=32, d_model=128)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
