"""Compute layer: the SDDMM body, its hand-written CUDA kernels, and the
graph ops (edge softmax, SpMM) over its output."""

from bsmr_sddmm_tpu_torch.ops.sddmm import (
    DevicePlan,
    device_plan,
    make_batched_sddmm_fn,
    make_sddmm_body,
    make_sddmm_fn,
    sddmm_ref,
)
from bsmr_sddmm_tpu_torch.ops import graph, graph_rphm, spmm

__all__ = ["DevicePlan", "device_plan", "make_batched_sddmm_fn",
           "make_sddmm_body", "make_sddmm_fn", "sddmm_ref", "graph",
           "graph_rphm", "spmm"]
