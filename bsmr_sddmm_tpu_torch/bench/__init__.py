"""Benchmark harness: suite bench, sweep runner, log analyzer, figure
plotters, replica suite.

The counterpart of ``bsmr_sddmm_tpu.bench`` (and of the JAX package's
``bench.py`` and ``scripts/run_replica_suite.py``): ``suite`` is the SUITE
sweep, ``replica_suite`` the SuiteSparse-replica sweep, both in-process on
the card; ``runner`` runs the CLI once per matrix in its own process;
``analyze`` and ``plot`` read the ``[key : value]`` logs they write.
"""

from bsmr_sddmm_tpu_torch.bench.analyze import (MatrixResult, analyze_logs,
                                                write_results_csv)
from bsmr_sddmm_tpu_torch.bench.runner import run_matrix, run_suite

__all__ = ["MatrixResult", "analyze_logs", "write_results_csv",
           "run_matrix", "run_suite"]
