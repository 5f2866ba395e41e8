"""Carry a plan and a config across from the JAX package.

``plan_from_reference`` and ``config_from_reference`` build this package's
``TilePlan`` and ``SddmmConfig`` from ``bsmr_sddmm_tpu``'s objects by
reading their attributes as NumPy arrays and Python values. They are
duck-typed: this module imports nothing from ``bsmr_sddmm_tpu`` (which
would import JAX), so the tests can hand the *same* plan to both bodies.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bsmr_sddmm_tpu_torch.config import SddmmConfig
from bsmr_sddmm_tpu_torch.pack import TilePlan

#: The JAX package's execution backends and this package's equivalents:
#: its plain XLA ops map to the plain PyTorch versions, its Pallas
#: kernels (and its "auto") to the hand kernels.
_BACKENDS = {"xla": "torch", "pallas": "auto", "auto": "auto"}


def _copy(value):
    if isinstance(value, np.ndarray):
        return value.copy()
    if isinstance(value, list):
        return [tuple(v) for v in value]
    return value


def plan_from_reference(ref_plan) -> TilePlan:
    """This package's TilePlan with every field of ``ref_plan`` (a
    ``bsmr_sddmm_tpu.pack.TilePlan``), arrays copied."""
    return TilePlan(**{f.name: _copy(getattr(ref_plan, f.name))
                       for f in dataclasses.fields(TilePlan)})


def config_from_reference(ref_cfg) -> SddmmConfig:
    """This package's SddmmConfig with every field of ``ref_cfg`` (a
    ``bsmr_sddmm_tpu.config.SddmmConfig``); the backend maps as in
    ``_BACKENDS``."""
    kw = {f.name: getattr(ref_cfg, f.name)
          for f in dataclasses.fields(SddmmConfig)}
    kw["backend"] = _BACKENDS[kw["backend"]]
    return SddmmConfig(**kw)
