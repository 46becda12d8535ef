from repro_torch.kernels.rwkv_scan.ops import rwkv_scan
from repro_torch.kernels.rwkv_scan.ref import rwkv_scan_ref

__all__ = ["rwkv_scan", "rwkv_scan_ref"]
