"""Public wrapper of the featurization kernel: the JAX package's padding
(Q to a power of two, L to a power of two ≥ 128), then the CUDA kernel for
CUDA tensors or the plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.featurize import kernel
from repro_torch.kernels.featurize.ref import hashed_embed_ref

# kernel launches since the last reset (the plain CPU path never counts)
launches = 0


def pad_pow2(n: int, floor: int = 1) -> int:
    """Next power of two ≥ n (≥ floor) — batch shapes are padded to this so
    every caller sees the same few shapes."""
    return max(floor, 1 << max(n - 1, 0).bit_length())


def hashed_embed(ids: torch.Tensor, weights: torch.Tensor,
                 proj: torch.Tensor) -> torch.Tensor:
    """ids/weights: (Q, L), id −1 = padding; proj: (hash_dim, dim) →
    (Q, dim) unit embeddings, on the inputs' device."""
    global launches
    if not (ids.device == weights.device == proj.device):
        raise ValueError(f"featurize inputs on different devices: "
                         f"{ids.device}, {weights.device}, {proj.device}")
    q, seq_l = ids.shape
    q_pad, l_pad = pad_pow2(q), pad_pow2(seq_l, floor=128)
    ids = ids.to(torch.int32)
    weights = weights.to(torch.float32)
    if (q_pad, l_pad) != (q, seq_l):
        ids = torch.nn.functional.pad(ids, (0, l_pad - seq_l, 0, q_pad - q),
                                      value=-1)
        weights = torch.nn.functional.pad(weights,
                                          (0, l_pad - seq_l, 0, q_pad - q))
    proj = proj.to(torch.float32).contiguous()
    if ids.device.type == "cpu":
        out = hashed_embed_ref(ids, weights, proj)
    elif ids.device.type == "cuda":
        if proj.data_ptr() % 16:           # the kernel reads float4 rows
            proj = proj.clone()
        out = kernel.hashed_embed_fwd(ids.contiguous(), weights.contiguous(),
                                      proj)
        launches += 1
    else:
        raise ValueError(f"featurize runs on cuda or cpu, not {ids.device}")
    return out[:q]
