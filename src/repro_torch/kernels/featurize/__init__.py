from repro_torch.kernels.featurize.ops import hashed_embed

__all__ = ["hashed_embed"]
