"""Dataset preparation tools.

A copy of ``bsmr_sddmm_tpu.datatools`` on this package's ``formats``: the
same conversions give the same files. Port of the reference's dataset
scripts (SURVEY.md section 2c):

* ``filter`` — the exclude_invalid_dataset.py semantics
  (scripts/exclude_invalid_dataset.py:44-76): keep matrices with
  m, n >= 10000 and nnz >= 100000; rewrite all values to 1; normalize
  complex/pattern headers to real. Invalid files are *moved aside* (to an
  ``excluded/`` sibling), not deleted, so ``unfilter`` can restore them
  (scripts/undo_exclusion.py).
* ``smtx2mtx`` — DLMC .smtx -> .mtx conversion
  (scripts/convert_smtx_to_mtx.py:4-52).
* ``mtx2npz`` — .mtx -> compressed npz CSR for fast reload
  (scripts/convert_mtx_to_npz.py).
* ``list`` — write a matrices list file for the suite runner
  (scripts/make_matrices_list.sh).

Downloading SuiteSparse/DLMC tarballs needs egress the benchmark host may
not have; the download step stays a documented manual step (the reference's
download_*.sh are thin wget loops).
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import List, Optional

import numpy as np

from bsmr_sddmm_tpu_torch.formats import (CSR, MatrixFormatError,
                                          load_matrix, save_mtx)

MIN_DIM = 10000      # exclude_invalid_dataset.py:47
MIN_NNZ = 100000


def matrix_is_valid(csr: CSR, min_dim: int = MIN_DIM,
                    min_nnz: int = MIN_NNZ) -> bool:
    return csr.rows >= min_dim and csr.cols >= min_dim and \
        csr.nnz >= min_nnz


def normalize_matrix(csr: CSR) -> CSR:
    """All values := 1 (the reference rewrites every kept matrix's values
    to 1 so benchmark numerics are mask-only)."""
    return CSR(csr.rows, csr.cols, csr.row_offsets.copy(),
               csr.col_indices.copy(),
               np.ones(csr.nnz, np.float32))


def filter_dataset(dataset_dir: str, excluded_dir: Optional[str] = None,
                   rewrite: bool = True, echo=print) -> List[str]:
    """Apply the validity filter to every .mtx under ``dataset_dir``.
    Returns the kept file paths; invalid/corrupt files move to
    ``excluded_dir`` (default: sibling 'excluded')."""
    excluded_dir = excluded_dir or os.path.join(dataset_dir, "excluded")
    kept = []
    for name in sorted(os.listdir(dataset_dir)):
        if not name.endswith((".mtx", ".mtx.gz")):
            continue
        path = os.path.join(dataset_dir, name)
        try:
            csr = load_matrix(path)
            ok = matrix_is_valid(csr)
        except MatrixFormatError as e:
            echo(f"exclude {name}: {e}")
            ok = False
            csr = None
        if ok:
            if rewrite and csr is not None and not name.endswith(".gz"):
                save_mtx(path, normalize_matrix(csr))
            kept.append(path)
        else:
            os.makedirs(excluded_dir, exist_ok=True)
            shutil.move(path, os.path.join(excluded_dir, name))
            echo(f"excluded {name}")
    return kept


def unfilter_dataset(dataset_dir: str,
                     excluded_dir: Optional[str] = None,
                     echo=print) -> int:
    """Move previously excluded files back (scripts/undo_exclusion.py)."""
    excluded_dir = excluded_dir or os.path.join(dataset_dir, "excluded")
    if not os.path.isdir(excluded_dir):
        return 0
    n = 0
    for name in sorted(os.listdir(excluded_dir)):
        shutil.move(os.path.join(excluded_dir, name),
                    os.path.join(dataset_dir, name))
        n += 1
        echo(f"restored {name}")
    return n


def convert_smtx_to_mtx(src: str, dst: Optional[str] = None) -> str:
    """DLMC .smtx -> MatrixMarket .mtx (convert_smtx_to_mtx.py:4-52)."""
    from bsmr_sddmm_tpu_torch.formats import load_smtx
    dst = dst or os.path.splitext(src)[0] + ".mtx"
    save_mtx(dst, load_smtx(src))
    return dst


def convert_mtx_to_npz(src: str, dst: Optional[str] = None) -> str:
    """Cache a parsed matrix as compressed npz (convert_mtx_to_npz.py);
    reload with :func:`load_npz` ~100x faster than re-parsing."""
    csr = load_matrix(src)
    dst = dst or os.path.splitext(src)[0] + ".npz"
    np.savez_compressed(dst, rows=csr.rows, cols=csr.cols,
                        row_offsets=csr.row_offsets,
                        col_indices=csr.col_indices, values=csr.values)
    return dst


def load_npz(path: str) -> CSR:
    with np.load(path) as z:
        return CSR(int(z["rows"]), int(z["cols"]), z["row_offsets"],
                   z["col_indices"], z["values"])


def make_matrices_list(dataset_dir: str, out_path: str) -> int:
    """Write one matrix path per line (make_matrices_list.sh)."""
    paths = [os.path.join(dataset_dir, n)
             for n in sorted(os.listdir(dataset_dir))
             if n.endswith((".mtx", ".mtx.gz", ".smtx", ".txt"))]
    with open(out_path, "w") as f:
        f.write("\n".join(paths) + ("\n" if paths else ""))
    return len(paths)


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="bsmr-data-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pf = sub.add_parser("filter")
    pf.add_argument("dataset_dir")
    pf.add_argument("--no-rewrite", action="store_true")
    pu = sub.add_parser("unfilter")
    pu.add_argument("dataset_dir")
    ps = sub.add_parser("smtx2mtx")
    ps.add_argument("src")
    ps.add_argument("dst", nargs="?")
    pn = sub.add_parser("mtx2npz")
    pn.add_argument("src")
    pn.add_argument("dst", nargs="?")
    pl = sub.add_parser("list")
    pl.add_argument("dataset_dir")
    pl.add_argument("out_path")
    args = p.parse_args(argv)
    if args.cmd == "filter":
        kept = filter_dataset(args.dataset_dir,
                              rewrite=not args.no_rewrite)
        print(f"{len(kept)} matrices kept")
    elif args.cmd == "unfilter":
        print(f"{unfilter_dataset(args.dataset_dir)} restored")
    elif args.cmd == "smtx2mtx":
        print(convert_smtx_to_mtx(args.src, args.dst))
    elif args.cmd == "mtx2npz":
        print(convert_mtx_to_npz(args.src, args.dst))
    else:
        print(f"{make_matrices_list(args.dataset_dir, args.out_path)} "
              "matrices listed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
