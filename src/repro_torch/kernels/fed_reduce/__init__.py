from repro_torch.kernels.fed_reduce.ops import fed_reduce, fed_reduce_ref

__all__ = ["fed_reduce", "fed_reduce_ref"]
