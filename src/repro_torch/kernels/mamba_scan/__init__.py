from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_fused
from repro_torch.kernels.mamba_scan.ref import (mamba_scan_fused_ref,
                                                mamba_scan_ref)

__all__ = ["mamba_scan", "mamba_scan_fused", "mamba_scan_fused_ref",
           "mamba_scan_ref"]
