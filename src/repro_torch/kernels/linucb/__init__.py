from repro_torch.kernels.linucb.ops import linucb_scores

__all__ = ["linucb_scores"]
