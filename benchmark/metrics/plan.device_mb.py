"""The plan's bytes on the card: the program's counter
``plan.device_bytes`` (the DevicePlan's tensors) of the last upload, in
units of 2**20 bytes."""


def read(run):
    from bsmr_sddmm_tpu_torch.utils import profiling
    if not hasattr(profiling, "counters"):
        return None                     # a program without counters
    value = profiling.counters().get("plan.device_bytes")
    return value / 2**20 if value else None
