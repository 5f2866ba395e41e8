"""Numerical validation with the reference's mixed tolerance.

A copy of ``bsmr_sddmm_tpu.utils.checkdata``. Mirrors
include/checkData.hpp:14-79: an element passes if
abs(a - b) < 1e-5 OR abs(a - b)/max(|a|, |b|) < 1e-3; the checker reports
the first few mismatches and the overall error rate.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

ABS_TOL = 1e-5   # checkData.hpp:16
REL_TOL = 1e-3   # checkData.hpp:17


@dataclasses.dataclass
class CheckResult:
    passed: bool
    num_errors: int
    total: int
    first_errors: List[Tuple[int, float, float]]

    @property
    def error_rate(self) -> float:
        return self.num_errors / self.total if self.total else 0.0

    def __str__(self) -> str:
        if self.passed:
            return f"checkResults : pass ({self.total} values)"
        lines = [f"checkResults : FAIL ({self.num_errors}/{self.total}, "
                 f"error rate {self.error_rate:.4%})"]
        for idx, a, b in self.first_errors:
            lines.append(f"  [{idx}] expected {a!r} got {b!r}")
        return "\n".join(lines)


def check_data(expected: np.ndarray, actual: np.ndarray,
               max_report: int = 10) -> CheckResult:
    expected = np.asarray(expected, dtype=np.float64).ravel()
    actual = np.asarray(actual, dtype=np.float64).ravel()
    if expected.shape != actual.shape:
        raise ValueError(
            f"shape mismatch: {expected.shape} vs {actual.shape}")
    abs_diff = np.abs(expected - actual)
    denom = np.maximum(np.abs(expected), np.abs(actual))
    with np.errstate(divide="ignore", invalid="ignore"):
        rel_diff = np.where(denom > 0, abs_diff / denom, 0.0)
    ok = (abs_diff < ABS_TOL) | (rel_diff < REL_TOL)
    bad = np.nonzero(~ok)[0]
    first = [(int(i), float(expected[i]), float(actual[i]))
             for i in bad[:max_report]]
    return CheckResult(passed=bad.size == 0, num_errors=int(bad.size),
                       total=int(expected.size), first_errors=first)
