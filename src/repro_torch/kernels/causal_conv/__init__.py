from repro_torch.kernels.causal_conv.ops import causal_conv, causal_conv_ref

__all__ = ["causal_conv", "causal_conv_ref"]
