"""Per-tier time breakdown across the suite's regimes: the port of
``scripts/profile_tiers.py``.

    python -m bsmr_sddmm_tpu_torch.tools.profile_tiers [K] [NAME,NAME,...] \
        [--device cpu]

For each ``datasets.SUITE`` and ``EXTRA`` matrix (or the named ones) at K
(default 128), alpha 0.3, delta 0.02: ``benchmark(tier_times=True)``, each
tier alone as a replayed CUDA graph on the card, and one line with the
headline, each tier's ms and cost per unit (tile or nonzero), and the sum
of the tiers over the headline (``tier_overlap_efficiency``). The packed
tier, which the JAX line leaves out, is in the line where the plan has it.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional, Sequence

from bsmr_sddmm_tpu_torch.ops.sddmm import resolve_device
from bsmr_sddmm_tpu_torch.tools import add_device_arg

DELTAS = (0.02,)


def profile(names: Optional[Sequence[str]], K: int, device,
            echo: Callable[[str], None] = print) -> List[dict]:
    """One record per (matrix, delta): the RunLog's counts and the tier
    times, with its line echoed."""
    from bsmr_sddmm_tpu_torch.config import SddmmConfig
    from bsmr_sddmm_tpu_torch.datasets import EXTRA, SUITE
    from bsmr_sddmm_tpu_torch.formats import make_dense
    from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm

    out = []
    for name, gen in SUITE + EXTRA:
        if names and name not in names:
            continue
        csr = gen()
        cfg = SddmmConfig(k=K, panel_height=32, num_iterations=10)
        pipe = BsmrSddmm(csr, cfg, device=device)
        A = make_dense(csr.rows, K, seed=1337)
        B = make_dense(K, csr.cols, seed=1338)
        for delta in DELTAS:
            log = pipe.benchmark(A, B, alpha=0.3, delta=delta, file=name,
                                 tier_times=True)
            e = log.extras
            T, Tp, Tg = (log.num_dense_blocks, log.num_packed_blocks,
                         log.num_gathered_blocks)
            rn = log.residual_nnz
            tier = {t: float(e.get(f"tier_{t}_ms", 0.0))
                    for t in ("dense", "packed", "gathered", "residual")}
            packed = (f"packed {tier['packed']:.3f} ms ({Tp} tiles, "
                      f"{tier['packed'] * 1e6 / Tp:.0f} ns/tile) | "
                      if Tp else "")
            echo(f"{name} d={delta} K={K}: {log.gflops:.0f} GFLOPS total "
                 f"{log.sddmm_ms:.3f} ms | dense {tier['dense']:.3f} ms "
                 f"({T} tiles, {log.dense_nnz} nnz, "
                 f"{tier['dense'] * 1e6 / max(T, 1):.0f} ns/tile) | "
                 f"{packed}gath {tier['gathered']:.3f} ms ({Tg} tiles, "
                 f"{log.gathered_nnz} nnz, "
                 f"{tier['gathered'] * 1e6 / max(Tg, 1):.0f} ns/tile) | "
                 f"res {tier['residual']:.3f} ms ({rn} nnz, "
                 f"{tier['residual'] * 1e6 / max(rn, 1):.1f} ns/nnz) | "
                 f"overlap {e['tier_overlap_efficiency']}")
            out.append(dict(matrix=name, delta=delta, k=K,
                            gflops=log.gflops, sddmm_ms=log.sddmm_ms,
                            tiles=T, packed=Tp, gathered=Tg, residual=rn,
                            tier_ms=tier,
                            overlap=float(e["tier_overlap_efficiency"]),
                            device=log.device))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="per-tier time breakdown over the suite matrices")
    p.add_argument("k", type=int, nargs="?", default=128)
    p.add_argument("names", nargs="?", default=None,
                   help="comma-separated matrix names (default: all of "
                        "SUITE and EXTRA)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    profile(args.names.split(",") if args.names else None, args.k, device,
            echo=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
