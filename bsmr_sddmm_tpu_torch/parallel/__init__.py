"""The parallel layer: row-panel sharding over a mesh of devices, the
B-panel ring, process bootstrap, weak scaling and the scaling model; the
counterpart of ``bsmr_sddmm_tpu.parallel`` on PyTorch (``collectives``
holds what ``shard_map`` and GSPMD do there implicitly)."""

from bsmr_sddmm_tpu_torch.parallel import collectives, distributed
from bsmr_sddmm_tpu_torch.parallel.ring import (make_ring_sddmm,
                                                pack_ring_plans,
                                                ring_operands)
from bsmr_sddmm_tpu_torch.parallel.scaling_model import (choose_layout,
                                                         predict_suite,
                                                         predict_weak_scaling)
from bsmr_sddmm_tpu_torch.parallel.sharding import (make_mesh,
                                                    make_sharded_sddmm,
                                                    shard_device_plan,
                                                    shard_operands,
                                                    sharded_rphm_to_csr)

__all__ = ["choose_layout", "distributed", "make_mesh",
           "make_sharded_sddmm",
           "make_ring_sddmm", "pack_ring_plans", "predict_suite",
           "predict_weak_scaling", "ring_operands", "shard_device_plan",
           "shard_operands", "sharded_rphm_to_csr"]
