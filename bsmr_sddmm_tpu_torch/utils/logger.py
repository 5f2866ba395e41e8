"""Benchmark record schema, kept wire-compatible with the reference.

A copy of ``bsmr_sddmm_tpu.utils.logger``: the same ``RunLog`` fields and
``[key : value]`` text, so the JAX package's ``bench/analyze.py`` reads this
package's logs.

The reference's single observability mechanism is the Logger struct
(include/Logger.hpp:13-187): `[key : value]` text records separated by
`---New data---` lines (src/sddmm.cu:113), parsed offline by
scripts/analyze_results.cpp. We keep the exact record syntax and the key
names the analyzer greps for, so the reference's analysis methodology
(best-config-per-matrix, speedup histograms, accuracy accounting) ports
unchanged, and add a JSON mirror for convenience.

GFLOPS = 2 * nnz * K / (sddmm_ms * 1e6)  (include/Logger.hpp:178-180).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

RECORD_SEPARATOR = "---New data---"


@dataclasses.dataclass
class RunLog:
    """One benchmark record (field names follow Logger.hpp:122-187)."""

    file: str = ""
    device: str = ""
    backend: str = ""
    m: int = 0
    n: int = 0
    k: int = 0
    nnz: int = 0
    sparsity: float = 0.0
    alpha: float = 0.0
    delta: float = 0.0
    panel_height: int = 0
    block_width: int = 0
    num_clusters: int = 0
    num_row_panels: int = 0
    num_dense_blocks: int = 0
    num_packed_blocks: int = 0
    num_gathered_blocks: int = 0
    dense_nnz: int = 0
    packed_nnz: int = 0
    gathered_nnz: int = 0
    residual_nnz: int = 0
    average_tile_density: float = 0.0
    row_reordering_ms: float = 0.0
    col_reordering_ms: float = 0.0
    pack_ms: float = 0.0
    sddmm_ms: float = 0.0
    check_result: str = "untested"
    error_rate: float = 0.0
    extras: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def gflops(self) -> float:
        if self.sddmm_ms <= 0:
            return 0.0
        return 2.0 * self.nnz * self.k / (self.sddmm_ms * 1e6)

    @property
    def nnz_per_s(self) -> float:
        if self.sddmm_ms <= 0:
            return 0.0
        return self.nnz / (self.sddmm_ms * 1e-3)

    def to_text(self) -> str:
        """Reference `[key : value]` record format (Logger.hpp:122-187)."""
        kv = [
            ("File", self.file),
            ("device", self.device),
            ("backend", self.backend),
            ("M", self.m),
            ("N", self.n),
            ("K", self.k),
            ("NNZ", self.nnz),
            ("sparsity", f"{self.sparsity:.6f}"),
            ("alpha", self.alpha),
            ("delta", self.delta),
            ("panel_height", self.panel_height),
            ("block_width", self.block_width),
            ("numClusters", self.num_clusters),
            ("numRowPanels", self.num_row_panels),
            ("numDenseBlocks", self.num_dense_blocks),
            ("numPackedBlocks", self.num_packed_blocks),
            ("numGatheredBlocks", self.num_gathered_blocks),
            ("denseNNZ", self.dense_nnz),
            ("packedNNZ", self.packed_nnz),
            ("gatheredNNZ", self.gathered_nnz),
            ("residualNNZ", self.residual_nnz),
            ("averageDensity", f"{self.average_tile_density:.6f}"),
            ("bsmr_rowReordering", f"{self.row_reordering_ms:.3f}"),
            ("bsmr_colReordering", f"{self.col_reordering_ms:.3f}"),
            ("rphm", f"{self.pack_ms:.3f}"),
            ("bsmr_sddmm", f"{self.sddmm_ms:.6f}"),
            ("bsmr_gflops", f"{self.gflops:.3f}"),
            ("bsmr_nnz_per_s", f"{self.nnz_per_s:.3e}"),
            ("checkResults", self.check_result),
            ("errorRate", f"{self.error_rate:.6f}"),
        ]
        kv += list(self.extras.items())
        body = "\n".join(f"[{k} : {v}]" for k, v in kv)
        return f"{RECORD_SEPARATOR}\n{body}\n"

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["gflops"] = self.gflops
        d["nnz_per_s"] = self.nnz_per_s
        return json.dumps(d)


def parse_log_text(text: str) -> list:
    """Parse `[key : value]` records back into dicts (the analyzer side,
    scripts/analyze_results.cpp:16-120)."""
    records = []
    for block in text.split(RECORD_SEPARATOR):
        kv = {}
        for line in block.splitlines():
            line = line.strip()
            if not (line.startswith("[") and line.endswith("]")
                    and " : " in line):
                continue
            key, val = line[1:-1].split(" : ", 1)
            kv[key.strip()] = val.strip()
        if kv:
            records.append(kv)
    return records
