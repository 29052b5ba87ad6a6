"""COO / CSR sparse-matrix containers and conversions (host side, NumPy).

Re-design of the reference containers:
  - ``coo_t`` (/root/reference/src/fpga/src/ip/coo_matrix.hpp:12-76)
  - ``coo2csr`` (/root/reference/src/common/utils/utils.hpp:523-580)

Arrays are always kept sorted row-major (row, then col), the invariant the
reference establishes with ``customSort`` (utils.hpp:350-370) before packing.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CooMatrix:
    """Sorted COO sparse matrix.

    rows/cols are int32, vals float32. ``num_rows``/``num_cols`` may exceed
    the max index + 1 (empty trailing rows/cols are allowed, unlike the
    reference which infers them; coo_matrix.hpp:29-40).
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    num_rows: int
    num_cols: int

    def __post_init__(self):
        self.rows = np.ascontiguousarray(self.rows, dtype=np.int32)
        self.cols = np.ascontiguousarray(self.cols, dtype=np.int32)
        self.vals = np.ascontiguousarray(self.vals, dtype=np.float32)
        if not (len(self.rows) == len(self.cols) == len(self.vals)):
            raise ValueError("rows/cols/vals length mismatch")
        self._sorted: "bool | None" = None  # lazy sortedness cache

    @property
    def nnz(self) -> int:
        return int(len(self.vals))

    def sort_row_major(self) -> "CooMatrix":
        order = np.lexsort((self.cols, self.rows))
        m = CooMatrix(
            self.rows[order], self.cols[order], self.vals[order],
            self.num_rows, self.num_cols,
        )
        m._sorted = True
        return m

    def is_sorted_row_major(self) -> bool:
        if self._sorted is None:
            from ..utils import native

            ok = native.coo_is_sorted(self.rows, self.cols)
            if ok is None:  # int32 compares, no int64 key materialization
                r, c = self.rows, self.cols
                ok = bool(len(r) < 2 or (
                    np.all(r[1:] >= r[:-1])
                    and np.all((r[1:] > r[:-1]) | (c[1:] >= c[:-1]))))
            self._sorted = ok
        return self._sorted

    def to_csr(self):
        """Return (row_ptr, cols, vals); requires row-major sorting."""
        row_ptr = np.zeros(self.num_rows + 1, dtype=np.int64)
        counts = np.bincount(self.rows, minlength=self.num_rows)
        np.cumsum(counts, out=row_ptr[1:])
        return row_ptr, self.cols, self.vals

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.vals, (self.rows, self.cols)),
            shape=(self.num_rows, self.num_cols),
        )

    def to_scipy_csr(self):
        """CSR backed by this COO's arrays — no data copy when already
        row-major sorted (scipy's COO->CSR conversion materializes a
        full copy, ~20 GB at 2G nnz). Duplicate (row, col) entries stay
        separate; dot products sum them, same semantics as to_scipy()."""
        import scipy.sparse as sp

        m = self if self.is_sorted_row_major() else self.sort_row_major()
        row_ptr, cols, vals = m.to_csr()
        return sp.csr_matrix(
            (vals, cols, row_ptr), shape=(m.num_rows, m.num_cols))

    def to_dense(self) -> np.ndarray:
        dense = np.zeros((self.num_rows, self.num_cols), dtype=np.float32)
        np.add.at(dense, (self.rows, self.cols), self.vals)
        return dense

    def row_degrees(self) -> np.ndarray:
        return np.bincount(self.rows, minlength=self.num_rows).astype(np.int32)

    def row_slice(self, start: int, stop: int) -> "CooMatrix":
        """Extract rows [start, stop) re-indexed to start at 0 (requires sorting)."""
        lo = np.searchsorted(self.rows, start, side="left")
        hi = np.searchsorted(self.rows, stop, side="left")
        m = CooMatrix(
            self.rows[lo:hi] - start, self.cols[lo:hi], self.vals[lo:hi],
            stop - start, self.num_cols,
        )
        m._sorted = self._sorted  # a slice of a sorted matrix stays sorted
        return m


def from_scipy(mat) -> CooMatrix:
    coo = mat.tocoo()
    return CooMatrix(
        coo.row.astype(np.int32), coo.col.astype(np.int32),
        coo.data.astype(np.float32), coo.shape[0], coo.shape[1],
    ).sort_row_major()


def from_dense(dense: np.ndarray) -> CooMatrix:
    rows, cols = np.nonzero(dense)
    return CooMatrix(
        rows.astype(np.int32), cols.astype(np.int32),
        dense[rows, cols].astype(np.float32), dense.shape[0], dense.shape[1],
    )
