"""Compute layer: the SDDMM body and its hand-written CUDA kernels."""

from bsmr_sddmm_tpu_torch.ops.sddmm import (
    DevicePlan,
    device_plan,
    make_sddmm_body,
    sddmm_ref,
)

__all__ = ["DevicePlan", "device_plan", "make_sddmm_body", "sddmm_ref"]
