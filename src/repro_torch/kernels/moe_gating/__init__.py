from repro_torch.kernels.moe_gating.ops import topk_gating

__all__ = ["topk_gating"]
