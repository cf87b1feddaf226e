from repro_torch.kernels.mamba2.ops import ssd

__all__ = ["ssd"]
