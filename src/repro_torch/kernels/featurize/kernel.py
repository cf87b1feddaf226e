"""ctypes launcher of the featurization kernel (``csrc/featurize.cu``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def hashed_embed_fwd(ids: torch.Tensor, weights: torch.Tensor,
                     proj: torch.Tensor) -> torch.Tensor:
    """ids int32 (Q, L), weights fp32 (Q, L), proj fp32 (H, D), contiguous
    CUDA tensors on one device → fp32 (Q, D), launched on the current
    stream.  A shape the kernel does not take (D > 1024, or H + D floats
    beyond a block's 48 KB of shared memory) is refused by the C launcher
    and raises."""
    q, seq_l = ids.shape
    hash_dim, dim = proj.shape
    out = torch.empty((q, dim), dtype=torch.float32, device=ids.device)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = build.library().featurize_launch(
        ids.data_ptr(), weights.data_ptr(), proj.data_ptr(), out.data_ptr(),
        q, seq_l, hash_dim, dim, stream)
    build.check(err, "featurize")
    return out
