"""Hand-written Hopper kernels — the router's (featurize, LinUCB) and the
models' (MoE gating, flash-attention prefill, decode attention over a
long cache, the RWKV6 WKV and Mamba2 SSD prefill scans) — each beside its
plain PyTorch version.

Each kernel package ships ``kernel.py`` (the ctypes launcher of the CUDA
kernel in ``csrc/``), ``ops.py`` (the public wrapper: the JAX package's
padding, then the kernel for CUDA tensors and the plain version for CPU
tensors, with a launch counter) and ``ref.py`` (the plain version).

No kernel has a backward pass (nor has any Pallas kernel of the JAX
package: training differentiates the models' plain paths, with
``use_pallas`` off).  So every wrapper refuses, on either device, an
input that requires grad while grad mode is on (``refuse_grad``): its
result would otherwise come back silently detached, and a training run
would miss the gradients of everything before it.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raise where grad mode is on and one of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the hand-written kernel has no backward pass, and an "
            f"input requires grad; run it under torch.no_grad(), or train "
            f"with use_pallas=False (the plain path autograd differentiates)")
