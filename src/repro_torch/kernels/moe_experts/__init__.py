from repro_torch.kernels.moe_experts.ops import moe_experts

__all__ = ["moe_experts"]
