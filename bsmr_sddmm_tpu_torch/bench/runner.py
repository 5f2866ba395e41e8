"""Suite runner: sweep a matrix list with per-matrix process isolation.

The counterpart of ``bsmr_sddmm_tpu.bench.runner`` on this package's CLI
(``bsmr_sddmm_tpu_torch.cli``) and baselines. Port of the reference's
scripts/test_script.sh:58-123 semantics:

* one OS process per matrix, so a crash/hang on one matrix cannot take
  down the sweep (SURVEY.md section 5, failure detection),
* append-only ``[key : value]`` logs with ``---New data---`` separators,
  so a killed sweep re-runs idempotently and the analyzer dedups by
  best-GFLOPS (checkpoint/resume semantics),
* per-run wall-clock timeout (the bash harness wall-times each run).

Baselines run through the same loop with the same schema, mirroring
scripts/run_baseline.sh. ``backend`` is the CLI's (``auto``: the CUDA
kernels on the card; ``torch``: their plain versions); ``device`` is
passed on as ``--device`` (default: the CLI's, the card).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import List, Optional, Sequence


def run_matrix(matrix_path: str, log_dir: str, k: int = 32,
               alpha: float = 0.3, delta: float = 0.3,
               test_mode: bool = False, backend: str = "auto",
               validate: bool = False, fast_bench: bool = False,
               timeout_s: float = 3600.0,
               device: Optional[str] = None) -> int:
    """Run one matrix in a fresh process via the CLI; returns exit code
    (124 on timeout, like coreutils timeout)."""
    cmd = [sys.executable, "-m", "bsmr_sddmm_tpu_torch.cli",
           "-f", matrix_path, "-k", str(k), "-a", str(alpha),
           "-d", str(delta), "-l", log_dir, "--backend", backend]
    if device:
        cmd += ["--device", device]
    if test_mode:
        cmd.append("-t")
    if validate:
        cmd.append("--validate")
    if fast_bench:
        cmd.append("--fast-bench")
    try:
        proc = subprocess.run(cmd, timeout=timeout_s)
        return proc.returncode
    except subprocess.TimeoutExpired:
        return 124


def run_baseline_matrix(matrix_path: str, log_dir: str, baseline: str,
                        k: int = 32, validate: bool = False,
                        timeout_s: float = 3600.0,
                        device: Optional[str] = None) -> int:
    """Run one baseline on one matrix in a fresh process (reference
    run_baseline.sh drives each baseline binary the same way)."""
    code = (
        "import sys\n"
        "from bsmr_sddmm_tpu_torch.baselines import benchmark_baseline\n"
        "from bsmr_sddmm_tpu_torch.formats import load_matrix, make_dense\n"
        "import os\n"
        f"csr = load_matrix({matrix_path!r})\n"
        f"A = make_dense(csr.rows, {k}, seed=1337)\n"
        f"B = make_dense({k}, csr.cols, seed=1338)\n"
        f"log = benchmark_baseline({baseline!r}, csr, A, B,"
        f" validate={validate}, device={device!r},"
        f" file=os.path.basename({matrix_path!r}))\n"
        "text = log.to_text()\n"
        "print(text)\n"
        f"path = os.path.join({log_dir!r}, "
        f"'{baseline}_k_{k}.log')\n"
        "open(path, 'a').write(text)\n"
        f"sys.exit(0 if (not {validate} or log.check_result == 'pass')"
        " else 1)\n"
    )
    try:
        proc = subprocess.run([sys.executable, "-c", code],
                              timeout=timeout_s)
        return proc.returncode
    except subprocess.TimeoutExpired:
        return 124


def run_suite(matrix_list: Sequence[str], log_dir: str,
              ks: Sequence[int] = (32,),
              alphas: Sequence[float] = (0.3,),
              deltas: Sequence[float] = (0.3,),
              baselines: Sequence[str] = (),
              test_mode: bool = False, backend: str = "auto",
              validate: bool = False, fast_bench: bool = False,
              timeout_s: float = 3600.0, device: Optional[str] = None,
              echo=print) -> List[dict]:
    """Run the whole suite; returns one status dict per (matrix, run)."""
    os.makedirs(log_dir, exist_ok=True)
    statuses = []
    for path in matrix_list:
        name = os.path.basename(path)
        for k in ks:
            for alpha in alphas:
                for delta in deltas:
                    t0 = time.time()
                    rc = run_matrix(path, log_dir, k=k, alpha=alpha,
                                    delta=delta, test_mode=test_mode,
                                    backend=backend, validate=validate,
                                    fast_bench=fast_bench,
                                    timeout_s=timeout_s, device=device)
                    dt = time.time() - t0
                    echo(f"[{name} k={k} a={alpha} d={delta} bsmr] "
                         f"rc={rc} {dt:.1f}s")
                    statuses.append(dict(file=name, k=k, method="bsmr",
                                         returncode=rc, seconds=dt))
                    if test_mode:
                        break  # test mode sweeps everything internally
                if test_mode:
                    break
            if test_mode:
                break
        for base in baselines:
            for k in ks:
                t0 = time.time()
                rc = run_baseline_matrix(path, log_dir, base, k=k,
                                         validate=validate,
                                         timeout_s=timeout_s, device=device)
                dt = time.time() - t0
                echo(f"[{name} k={k} {base}] rc={rc} {dt:.1f}s")
                statuses.append(dict(file=name, k=k, method=base,
                                     returncode=rc, seconds=dt))
    return statuses


def main(argv=None) -> int:
    import argparse

    from bsmr_sddmm_tpu_torch.baselines import BASELINE_NAMES
    p = argparse.ArgumentParser(
        prog="bsmr-run-suite-torch",
        description="Benchmark a list of matrices with per-matrix process "
                    "isolation (reference scripts/test_script.sh)")
    p.add_argument("-f", "--matrix-list", required=True,
                   help="text file with one matrix path per line")
    p.add_argument("-l", "--log-dir", required=True)
    p.add_argument("-k", type=int, action="append", default=None)
    p.add_argument("-a", "--alpha", type=float, action="append",
                   default=None)
    p.add_argument("-d", "--delta", type=float, action="append",
                   default=None)
    p.add_argument("-t", "--test-mode", action="store_true")
    p.add_argument("--baselines", nargs="*", default=[],
                   choices=list(BASELINE_NAMES))
    p.add_argument("--backend", choices=["auto", "torch"], default="auto")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="passed on to every run (default: the card)")
    p.add_argument("--validate", action="store_true")
    p.add_argument("--fast-bench", action="store_true")
    p.add_argument("--timeout", type=float, default=3600.0)
    args = p.parse_args(argv)
    with open(args.matrix_list) as f:
        matrices = [ln.strip() for ln in f if ln.strip()
                    and not ln.startswith("#")]
    statuses = run_suite(matrices, args.log_dir, ks=args.k or (32,),
                         alphas=args.alpha or (0.3,),
                         deltas=args.delta or (0.3,),
                         baselines=args.baselines,
                         test_mode=args.test_mode, backend=args.backend,
                         validate=args.validate,
                         fast_bench=args.fast_bench,
                         timeout_s=args.timeout, device=args.device)
    failures = [s for s in statuses if s["returncode"] != 0]
    print(f"{len(statuses) - len(failures)}/{len(statuses)} runs ok")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
