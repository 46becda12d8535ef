from repro_torch.kernels.gemv.ops import gemv, quantize_weight
from repro_torch.kernels.gemv.ref import gemv_ref

__all__ = ["gemv", "gemv_ref", "quantize_weight"]
