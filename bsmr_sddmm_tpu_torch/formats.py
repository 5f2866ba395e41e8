"""Sparse/dense matrix containers and file IO.

A copy of ``bsmr_sddmm_tpu.formats`` (plain NumPy, no JAX), kept in this
package because importing anything from ``bsmr_sddmm_tpu`` imports JAX.
Identical inputs give identical arrays in both packages
(tests/test_torch_host.py). The data layer re-designs the CUDA original's
(include/Matrix.hpp:40-401, src/Matrix.cpp:17-954): plain NumPy arrays with
vectorized parsers instead of C++ line-by-line readers, with the same
validation semantics (duplicate entries, out-of-range indices and wrong
counts are rejected — src/Matrix.cpp:355-366, 442-465) and the same
deterministic random-fill convention (uniform [0, 2),
src/Matrix.cpp:113-138).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import numpy as np


class MatrixFormatError(ValueError):
    """Raised on malformed sparse-matrix files (reference prints + returns
    false, src/Matrix.cpp:355-366; we raise)."""


def _fromtext(text: str, dtype=np.float64) -> np.ndarray:
    """Fast whole-buffer numeric text parse."""
    if not text or not text.strip():
        return np.zeros(0, dtype)
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return np.fromstring(text, dtype=dtype, sep=" ")


@dataclasses.dataclass
class COO:
    """Coordinate-format sparse matrix (reference sparseMatrix::COO,
    include/Matrix.hpp)."""

    rows: int
    cols: int
    row_indices: np.ndarray  # (nnz,) int32
    col_indices: np.ndarray  # (nnz,) int32
    values: np.ndarray       # (nnz,) float32

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])

    def to_csr(self) -> "CSR":
        order = np.lexsort((self.col_indices, self.row_indices))
        ri = self.row_indices[order]
        ci = self.col_indices[order]
        vals = self.values[order]
        row_offsets = np.zeros(self.rows + 1, dtype=np.int64)
        np.add.at(row_offsets, ri + 1, 1)
        row_offsets = np.cumsum(row_offsets)
        return CSR(self.rows, self.cols, row_offsets.astype(np.int64),
                   ci.astype(np.int32), vals.astype(np.float32))


@dataclasses.dataclass
class CSR:
    """Compressed-sparse-row matrix (reference sparseMatrix::CSR,
    include/Matrix.hpp:198-300)."""

    rows: int
    cols: int
    row_offsets: np.ndarray  # (rows+1,) int64, monotone
    col_indices: np.ndarray  # (nnz,) int32
    values: np.ndarray       # (nnz,) float32

    @property
    def nnz(self) -> int:
        return int(self.col_indices.shape[0])

    @property
    def sparsity(self) -> float:
        denom = float(self.rows) * float(self.cols)
        return 1.0 - self.nnz / denom if denom else 0.0

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.row_offsets)

    def coo_rows(self) -> np.ndarray:
        """Expand row ids per nonzero (row index of each CSR slot)."""
        return np.repeat(
            np.arange(self.rows, dtype=np.int32), self.row_nnz()
        )

    def to_coo(self) -> COO:
        return COO(self.rows, self.cols, self.coo_rows(),
                   self.col_indices.copy(), self.values.copy())

    def validate(self) -> None:
        """Structural checks, mirroring checkMatrixData
        (src/Matrix.cpp:917-952) + duplicate detection
        (src/Matrix.cpp:442-465)."""
        ro = self.row_offsets
        if ro.shape[0] != self.rows + 1:
            raise MatrixFormatError("row_offsets length != rows+1")
        if ro[0] != 0 or ro[-1] != self.nnz:
            raise MatrixFormatError("row_offsets endpoints wrong")
        if np.any(np.diff(ro) < 0):
            raise MatrixFormatError("row_offsets not monotone")
        if self.nnz and (self.col_indices.min() < 0
                         or self.col_indices.max() >= self.cols):
            raise MatrixFormatError("column index out of range")
        # duplicate (row, col) detection, vectorized
        rows = self.coo_rows().astype(np.int64)
        keys = rows * np.int64(self.cols) + self.col_indices.astype(np.int64)
        if np.unique(keys).shape[0] != self.nnz:
            raise MatrixFormatError("matrix has duplicate entries")


# ---------------------------------------------------------------------------
# Parsers
# ---------------------------------------------------------------------------

def _read_text(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path, "r") as f:
        return f.read()


def load_mtx(path: str, validate: bool = True) -> CSR:
    """Matrix Market coordinate parser (reference initializeFromMtxFile,
    src/Matrix.cpp:399-480; 1-based indices, duplicate/bounds checks).

    Additionally handles the standard `pattern` field (values := 1) and
    `symmetric` symmetry (mirror off-diagonal entries) which the reference
    dataset-prep normalizes away (scripts/exclude_invalid_dataset.py:44-76).
    """
    text = _read_text(path)
    pattern = False
    symmetric = False
    pos = 0
    header_seen = False
    # consume comment/header lines
    while pos < len(text):
        eol = text.find("\n", pos)
        if eol == -1:
            eol = len(text)
        line = text[pos:eol]
        stripped = line.strip()
        if stripped.startswith("%"):
            if not header_seen and stripped.lower().startswith("%%matrixmarket"):
                header_seen = True
                toks = stripped.lower().split()
                if "coordinate" not in toks:
                    raise MatrixFormatError(
                        f"{path}: only coordinate format is supported")
                pattern = "pattern" in toks
                if "complex" in toks:
                    raise MatrixFormatError(
                        f"{path}: complex matrices not supported "
                        "(dataset prep rewrites them to real)")
                symmetric = "symmetric" in toks or "skew-symmetric" in toks \
                    or "hermitian" in toks
            pos = eol + 1
            continue
        if not stripped:
            pos = eol + 1
            continue
        break
    size_eol = text.find("\n", pos)
    if size_eol == -1:
        size_eol = len(text)
    size_toks = text[pos:size_eol].split()
    if len(size_toks) < 3:
        raise MatrixFormatError(f"{path}: bad size line")
    rows, cols, nnz = int(size_toks[0]), int(size_toks[1]), int(size_toks[2])
    body = text[size_eol + 1:]
    del text
    flat = _fromtext(body)
    del body
    ncols_per_line = 2 if pattern else 3
    if flat.size % ncols_per_line != 0:
        # Some "real" files omit values on some lines; reference treats a
        # missing value as 0 (src/Matrix.cpp:388-391). We only support
        # uniform layouts; try pattern layout as fallback.
        if flat.size % 2 == 0 and not pattern:
            ncols_per_line = 2
            pattern = True
        else:
            raise MatrixFormatError(f"{path}: ragged entry lines")
    entries = flat.reshape(-1, ncols_per_line)
    del flat
    if entries.shape[0] != nnz:
        raise MatrixFormatError(
            f"{path}: expected {nnz} entries, found {entries.shape[0]}"
            " (too many / not enough elements)")
    ri = entries[:, 0].astype(np.int64) - 1  # 1-based (src/Matrix.cpp:436)
    ci = entries[:, 1].astype(np.int64) - 1
    vals = (np.ones(nnz, np.float32) if pattern
            else entries[:, 2].astype(np.float32))
    del entries
    if nnz and (ri.min() < 0 or ri.max() >= rows
                or ci.min() < 0 or ci.max() >= cols):
        raise MatrixFormatError(f"{path}: row or col is too big")
    if symmetric:
        off_diag = ri != ci
        ri, ci, vals = (np.concatenate([ri, ci[off_diag]]),
                        np.concatenate([ci, ri[off_diag]]),
                        np.concatenate([vals, vals[off_diag]]))
    coo = COO(rows, cols, ri.astype(np.int32), ci.astype(np.int32), vals)
    csr = coo.to_csr()
    if validate:
        csr.validate()
    if csr.nnz <= 1:
        raise MatrixFormatError(f"{path}: nnz <= 1 is not a valid matrix")
    return csr


def load_smtx(path: str) -> CSR:
    """DLMC ``.smtx`` CSR parser (reference initializeFromSmtxFile,
    src/Matrix.cpp:297-371): header "rows cols nnz" (comma or space
    separated), one line of row offsets, one line of column indices;
    values are all 1."""
    text = _read_text(path)
    lines = [ln for ln in text.split("\n") if ln.strip()
             and not ln.lstrip().startswith("%")]
    if len(lines) < 3:
        raise MatrixFormatError(f"{path}: smtx needs 3 content lines")
    head = lines[0].replace(",", " ").split()
    rows, cols, nnz = int(head[0]), int(head[1]), int(head[2])
    if nnz == 0:
        raise MatrixFormatError(f"{path}: nnz is 0")
    row_offsets = _fromtext(lines[1], np.int64)
    col_indices = _fromtext(lines[2], np.int64)
    if row_offsets.size != rows + 1:
        raise MatrixFormatError(f"{path}: rowOffsets is not enough")
    if col_indices.size != nnz:
        raise MatrixFormatError(f"{path}: nnz is not enough")
    csr = CSR(rows, cols, row_offsets,
              col_indices.astype(np.int32), np.ones(nnz, np.float32))
    csr.validate()
    return csr


def load_snap_txt(path: str) -> CSR:
    """SNAP edge-list ``.txt`` parser (reference initializeFromTxtFile,
    src/Matrix.cpp:483-585): '#'-comment lines, one 0-based "src dst" edge
    per line; matrix is square over max node id + 1, values are 1.
    Duplicate edges are dropped (the reference rejects them; SNAP graphs
    commonly contain both directions, so we dedup)."""
    text = _read_text(path)
    body_lines = [ln for ln in text.split("\n")
                  if ln.strip() and not ln.lstrip().startswith(("#", "%"))]
    flat = _fromtext(" ".join(body_lines), np.int64)
    if flat.size % 2 != 0:
        raise MatrixFormatError(f"{path}: ragged edge lines")
    edges = flat.reshape(-1, 2)
    n = int(edges.max()) + 1 if edges.size else 0
    keys = edges[:, 0] * np.int64(n) + edges[:, 1]
    _, first = np.unique(keys, return_index=True)
    edges = edges[np.sort(first)]
    coo = COO(n, n, edges[:, 0].astype(np.int32),
              edges[:, 1].astype(np.int32),
              np.ones(edges.shape[0], np.float32))
    return coo.to_csr()


def load_matrix(path: str) -> CSR:
    """Dispatch by file suffix (reference initializeFromMatrixFile,
    src/Matrix.cpp:280-294)."""
    base = path[:-3] if path.endswith(".gz") else path
    suffix = os.path.splitext(base)[1].lower()
    if suffix == ".mtx":
        return load_mtx(path)
    if suffix == ".smtx":
        return load_smtx(path)
    if suffix == ".txt":
        return load_snap_txt(path)
    raise MatrixFormatError(f"unsupported matrix suffix: {path}")


def save_mtx(path: str, csr: CSR) -> None:
    """Matrix Market writer (reference outputToMarketMatrixFile,
    src/Matrix.cpp:698-744)."""
    rows = csr.coo_rows() + 1
    cols = csr.col_indices + 1
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{csr.rows} {csr.cols} {csr.nnz}\n")
        np.savetxt(f, np.column_stack(
            [rows, cols, csr.values]), fmt="%d %d %.6g")


# ---------------------------------------------------------------------------
# Dense operands + synthetic masks
# ---------------------------------------------------------------------------

def make_dense(rows: int, cols: int, seed: int = 1337,
               dtype=np.float32) -> np.ndarray:
    """Deterministic uniform [0, 2) fill, matching the reference convention
    (Matrix::makeData mt19937 uniform [0,2), src/Matrix.cpp:113-138; cuRAND
    seed 1337, src/cudaUtil.cu:31)."""
    rng = np.random.default_rng(seed)
    return (rng.random((rows, cols), dtype=np.float32) * 2.0).astype(dtype)


def random_mask(rows: int, cols: int, nnz: int, seed: int = 0,
                block_rows: int = 0, block_cols: int = 0,
                block_fill: float = 0.6, shuffle_rows: bool = True) -> CSR:
    """Synthetic sparse mask generator for tests/benchmarks.

    With ``block_rows/cols`` set, plants dense rectangular blocks (so the
    reorderer has structure to find) and sprinkles the remaining nnz
    uniformly — a stand-in for SuiteSparse structure when the dataset
    cannot be downloaded. ``shuffle_rows`` scatters the planted blocks
    across non-contiguous rows, which is what makes row reordering matter.
    """
    rng = np.random.default_rng(seed)
    ri_parts, ci_parts = [], []
    remaining = nnz
    if block_rows and block_cols:
        n_blocks = max(1, int(nnz * block_fill)
                       // max(1, block_rows * block_cols))
        for _ in range(n_blocks):
            r0 = int(rng.integers(0, max(1, rows - block_rows)))
            c0 = int(rng.integers(0, max(1, cols - block_cols)))
            rr, cc = np.meshgrid(np.arange(r0, r0 + block_rows),
                                 np.arange(c0, c0 + block_cols),
                                 indexing="ij")
            keep = rng.random(rr.size) < 0.85  # blocks are dense, not full
            ri_parts.append(rr.ravel()[keep])
            ci_parts.append(cc.ravel()[keep])
        planted = sum(p.size for p in ri_parts)
        remaining = max(0, nnz - planted)
    if remaining:
        ri_parts.append(rng.integers(0, rows, remaining))
        ci_parts.append(rng.integers(0, cols, remaining))
    ri = np.concatenate(ri_parts).astype(np.int64)
    ci = np.concatenate(ci_parts).astype(np.int64)
    if shuffle_rows:
        row_map = rng.permutation(rows).astype(np.int64)
        ri = row_map[ri]
    keys = ri * np.int64(cols) + ci
    uniq = np.unique(keys)
    ri = (uniq // cols).astype(np.int32)
    ci = (uniq % cols).astype(np.int32)
    vals = np.ones(uniq.shape[0], np.float32)
    return COO(rows, cols, ri, ci, vals).to_csr()
