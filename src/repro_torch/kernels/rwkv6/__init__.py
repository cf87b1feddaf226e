from repro_torch.kernels.rwkv6.ops import wkv

__all__ = ["wkv"]
