"""CLI driver, console script ``bsmr-sddmm-torch``: the flags of the JAX
package's ``bsmr-sddmm`` (CUDA original ./BSMR-sddmm, src/main.cu:6-42,
include/Options.hpp:49-76): `-f` matrix file, `-k` K, `-a` alpha, `-d`
delta, `-t` test mode, `-l` log dir, plus --backend, --panel-height,
--col-mode, --validate, --evaluate, --tier-times, --reorder-cache, the
autotune flags --auto-delta, --auto-alpha and --refine-top, and --device."""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="bsmr-sddmm-torch",
        description="Block-structured SDDMM (BSMR) on PyTorch + CUDA")
    p.add_argument("-f", "--file", required=True, help="matrix file "
                   "(.mtx/.smtx/.txt, optionally .gz)")
    p.add_argument("-k", type=int, default=32, help="K dim (default 32)")
    p.add_argument("-a", "--alpha", type=float, default=0.3,
                   help="row-similarity threshold (default 0.3)")
    p.add_argument("-d", "--delta", type=float, default=0.3,
                   help="block-density threshold (default 0.3)")
    p.add_argument("-t", "--test-mode", action="store_true",
                   help="alpha x delta x K sweep (original -t 1, "
                        "src/sddmm.cu:62-118)")
    p.add_argument("-l", "--log-dir", default="",
                   help="directory for [key : value] log files")
    p.add_argument("--backend", choices=["auto", "torch"], default="auto",
                   help="auto: CUDA kernels on the GPU; torch: their plain "
                        "PyTorch versions")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="where the body runs (default: cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--panel-height", type=int, default=32)
    p.add_argument("--col-mode", choices=["bsr", "reorder"], default="bsr")
    p.add_argument("--residual-mode", choices=["gathered", "pernnz"],
                   default="gathered")
    p.add_argument("--row-strategy", choices=["exact", "fast", "none"],
                   default="fast")
    p.add_argument("--subpack-min-nnz", type=int, default=12,
                   help="nonzeros a 32-wide aligned column sub-block "
                        "needs to join the packed tile tier (0 disables)")
    p.add_argument("--subblock-width", type=int, default=32)
    p.add_argument("--out-dtype", choices=["float32", "float16"],
                   default="float32",
                   help="output value dtype (fp32 accumulate, narrow store)")
    p.add_argument("--validate", action="store_true",
                   help="check against the fp64 CPU oracle (original "
                        "#define VALIDATE, src/sddmm.cu:7)")
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--fast-bench", action="store_true",
                   help="skip the separately-timed CSR-order emission")
    p.add_argument("--reorder-cache", action="store_true",
                   help="cache row reorderings on disk (BSMR_CACHE_DIR; "
                        "the same entries as the JAX package's)")
    p.add_argument("--evaluate", action="store_true",
                   help="append reordered-vs-original tiling statistics "
                        "to the log (original evaluationReordering)")
    p.add_argument("--tier-times", action="store_true",
                   help="measure and log the per-tier time split "
                        "(dense/packed/gathered/residual ms + overlap "
                        "efficiency)")
    p.add_argument("--auto-delta", action="store_true",
                   help="pick delta per matrix from the tier cost model "
                        "instead of -d (the dense fallback competes)")
    p.add_argument("--auto-alpha", action="store_true",
                   help="also put alpha in the autotuner's choice set "
                        "(prices the full alpha x delta x subpack grid; "
                        "implies --auto-delta)")
    p.add_argument("--refine-top", type=int, default=0,
                   help="with --auto-alpha: re-time the N best-priced "
                        "plans on the card and pick the measured argmin")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from bsmr_sddmm_tpu_torch.config import (SWEEP_ALPHAS, SWEEP_DELTAS,
                                             SWEEP_KS, SddmmConfig)
    from bsmr_sddmm_tpu_torch.formats import load_matrix, make_dense
    from bsmr_sddmm_tpu_torch.sddmm import BsmrSddmm

    csr = load_matrix(args.file)
    name = os.path.basename(args.file)
    print(f"[File : {name}] [M : {csr.rows}] [N : {csr.cols}] "
          f"[NNZ : {csr.nnz}]")

    cfg = SddmmConfig(k=args.k, alpha=args.alpha, delta=args.delta,
                      panel_height=args.panel_height,
                      backend=args.backend,
                      col_mode=args.col_mode,
                      residual_mode=args.residual_mode,
                      row_strategy=args.row_strategy,
                      subpack_min_nnz=args.subpack_min_nnz,
                      subblock_width=args.subblock_width,
                      out_dtype=args.out_dtype,
                      reorder_cache=args.reorder_cache,
                      num_iterations=args.iterations,
                      autotune_refine_top=args.refine_top)
    pipe = BsmrSddmm(csr, cfg, device=args.device)

    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    def emit(log, tag):
        text = log.to_text()
        print(text)
        if args.log_dir:
            with open(os.path.join(args.log_dir, tag + ".log"), "a") as f:
                f.write(text)

    if not args.test_mode:
        A = make_dense(csr.rows, args.k, seed=1337)
        B = make_dense(args.k, csr.cols, seed=1338)
        delta = "auto" if (args.auto_delta or args.auto_alpha) else None
        alpha = "auto" if args.auto_alpha else None
        log = pipe.benchmark(A, B, alpha=alpha, delta=delta,
                             validate=args.validate,
                             time_csr_emit=not args.fast_bench,
                             tier_times=args.tier_times, file=name)
        if args.evaluate:
            from bsmr_sddmm_tpu_torch.evaluate import evaluate_reordering
            ev = evaluate_reordering(csr, cfg.replace(delta=log.delta))
            log.extras.update(ev.as_extras())
        tag_a = "auto" if args.auto_alpha else args.alpha
        tag_d = "auto" if delta == "auto" else args.delta
        emit(log, f"BSMR_k_{args.k}_a_{tag_a}_d_{tag_d}")
        return 0 if (not args.validate or log.check_result == "pass") else 1

    # test mode: sweep alpha x delta x K, row reordering reused per alpha
    # (src/sddmm.cu:62-118); log file naming matches the original
    # (src/sddmm.cu:104-114)
    failures = 0
    for alpha in SWEEP_ALPHAS:
        for delta in SWEEP_DELTAS:
            for k in SWEEP_KS:
                A = make_dense(csr.rows, k, seed=1337)
                B = make_dense(k, csr.cols, seed=1338)
                pipe.config = cfg.replace(k=k)
                log = pipe.benchmark(A, B, alpha=alpha, delta=delta,
                                     validate=args.validate,
                                     time_csr_emit=not args.fast_bench,
                                     file=name)
                emit(log, f"BSMR_k_{k}_a_{alpha}_d_{delta}")
                if args.validate and log.check_result != "pass":
                    failures += 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
