"""Hand-written Hopper kernels — the router's (featurize, LinUCB) and the
models' (MoE gating, flash-attention prefill, decode attention over a
long cache, the RWKV6 WKV and Mamba2 SSD prefill scans) — each beside its
plain PyTorch version.

Each kernel package ships ``kernel.py`` (the ctypes launcher of the CUDA
kernel in ``csrc/``), ``ops.py`` (the public wrapper: the JAX package's
padding, then the kernel for CUDA tensors and the plain version for CPU
tensors, with a launch counter) and ``ref.py`` (the plain version).
"""
