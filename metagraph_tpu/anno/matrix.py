"""Binary annotation matrices as sorted-COO device tensors.

Device replacement for the reference's BinaryMatrix hierarchy
(metagraph/src/annotation/binary_matrix/base/binary_matrix.hpp:16-50).
The workhorse here is a single representation, ``RowSparse``: the set of
(row, column) bits sorted by (row, column), as two aligned device arrays
(+ optional per-bit integer values for count annotations — the IntMatrix
role, int_matrix/base/int_matrix.hpp:13).

Queries are batched and gather-shaped:
  * ``get_rows``: per-row [lo, hi) ranges by vectorized binary search,
    expanded to a flat (query, column) hit list with one searchsorted
    over the size-prefix array (the "interval expand" trick) — no
    per-row loops, no ragged tensors;
  * ``sum_rows`` (the query hot path, reference binary_matrix.cpp:40-90):
    interval-expand then one segment-sum over columns.

Compressed representations (Multi-BRWT, row-diff) plug in behind the
same interface; RowSparse is also their construction/exchange format.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _expand_intervals(lo: jax.Array, hi: jax.Array, capacity: int
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Flatten per-query [lo, hi) ranges into (query_idx, flat_idx) pairs.

    Returns (query_idx (C,), flat_idx (C,), valid (C,)). Entry p of the
    output enumerates the p-th element across all ranges in query order.
    """
    sizes = jnp.maximum(hi - lo, 0)
    starts = jnp.concatenate([jnp.zeros((1,), sizes.dtype), jnp.cumsum(sizes)])
    total = starts[-1]
    p = jnp.arange(capacity, dtype=jnp.int32)
    q = jnp.searchsorted(starts, p, side="right").astype(jnp.int32) - 1
    qc = jnp.clip(q, 0, lo.shape[0] - 1)
    flat = lo[qc] + (p - starts[qc])
    valid = p < total
    return qc, flat, valid


@dataclass(frozen=True)
class RowSparse:
    """Sorted-COO binary matrix with optional integer values."""
    rows: jax.Array              # (nnz,) int32, sorted
    cols: jax.Array              # (nnz,) int32, sorted within row
    num_rows: int
    num_cols: int
    values: Optional[jax.Array] = None   # (nnz,) int32 (count annotations)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @staticmethod
    def from_coo(rows, cols, num_rows: int, num_cols: int, values=None,
                 dedupe: bool = True) -> "RowSparse":
        rows = jnp.asarray(rows, jnp.int32)
        cols = jnp.asarray(cols, jnp.int32)
        # sort by (row, col) with two-key lax.sort
        if values is not None:
            values = jnp.asarray(values, jnp.int32)
            r, c, v = jax.lax.sort((rows, cols, values), num_keys=2)
        else:
            r, c = jax.lax.sort((rows, cols), num_keys=2)
            v = None
        if dedupe and r.shape[0] > 0:
            first = jnp.concatenate([
                jnp.ones((1,), bool),
                (r[1:] != r[:-1]) | (c[1:] != c[:-1])])
            idx = jnp.nonzero(first)[0]  # host-side build path: concrete ok
            r, c = r[idx], c[idx]
            if v is not None:
                seg = jnp.cumsum(first.astype(jnp.int32)) - 1
                v = jax.ops.segment_sum(v, seg, num_segments=idx.shape[0])
        return RowSparse(rows=r, cols=c, num_rows=num_rows, num_cols=num_cols,
                         values=v)

    # -- queries -----------------------------------------------------------

    def row_ranges(self, row_idx: jax.Array) -> Tuple[jax.Array, jax.Array]:
        lo = jnp.searchsorted(self.rows, row_idx, side="left").astype(jnp.int32)
        hi = jnp.searchsorted(self.rows, row_idx, side="right").astype(jnp.int32)
        return lo, hi

    def _expand_capacity(self, lo, hi, capacity: Optional[int]) -> int:
        """Exact flat-hit capacity. With duplicate query rows the total can
        exceed nnz, so compute it from the ranges when running eagerly."""
        if capacity is not None:
            return capacity
        try:
            exact = max(int(jnp.sum(jnp.maximum(hi - lo, 0))), 1)
        except jax.errors.TracerArrayConversionError:
            return max(int(self.nnz), 1)
        # round up to a power of two: bounds recompilation across calls
        return 1 << (exact - 1).bit_length() if exact > 1 else 1

    def sum_rows(self, row_idx: jax.Array, weights: jax.Array,
                 capacity: Optional[int] = None) -> jax.Array:
        """(num_cols,) weighted count of set bits per column over the given
        rows (reference BinaryMatrix::sum_rows, binary_matrix.cpp:40)."""
        lo, hi = self.row_ranges(row_idx)
        cap = self._expand_capacity(lo, hi, capacity)
        q, flat, valid = _expand_intervals(lo, hi, cap)
        col = self.cols[jnp.clip(flat, 0, max(self.nnz - 1, 0))]
        w = jnp.where(valid, weights[q], 0)
        return jax.ops.segment_sum(w, col, num_segments=self.num_cols)

    def sum_row_values(self, row_idx: jax.Array, weights: jax.Array,
                       capacity: Optional[int] = None) -> jax.Array:
        """(num_cols,) weighted sum of VALUES per column (IntMatrix
        sum_row_values, int_matrix.hpp:34) — for --query-counts."""
        assert self.values is not None
        lo, hi = self.row_ranges(row_idx)
        cap = self._expand_capacity(lo, hi, capacity)
        q, flat, valid = _expand_intervals(lo, hi, cap)
        fc = jnp.clip(flat, 0, max(self.nnz - 1, 0))
        col = self.cols[fc]
        w = jnp.where(valid, weights[q] * self.values[fc], 0)
        return jax.ops.segment_sum(w, col, num_segments=self.num_cols)

    def presence(self, row_idx: jax.Array, capacity: Optional[int] = None
                 ) -> jax.Array:
        """(Q, num_cols) bool presence mask per queried row (the
        per-k-mer signature used by get_top_label_signatures)."""
        lo, hi = self.row_ranges(row_idx)
        cap = self._expand_capacity(lo, hi, capacity)
        q, flat, valid = _expand_intervals(lo, hi, cap)
        col = self.cols[jnp.clip(flat, 0, max(self.nnz - 1, 0))]
        out = jnp.zeros((row_idx.shape[0], self.num_cols), bool)
        qs = jnp.where(valid, q, row_idx.shape[0])
        return out.at[qs, col].set(True, mode="drop")

    def values_dense(self, row_idx: jax.Array,
                     capacity: Optional[int] = None) -> jax.Array:
        """(Q, num_cols) int32 dense values per queried row (0 where
        unset) — the IntMatrix::get_row_values role with static shapes."""
        assert self.values is not None
        lo, hi = self.row_ranges(row_idx)
        cap = self._expand_capacity(lo, hi, capacity)
        q, flat, valid = _expand_intervals(lo, hi, cap)
        fc = jnp.clip(flat, 0, max(self.nnz - 1, 0))
        col = self.cols[fc]
        out = jnp.zeros((row_idx.shape[0], self.num_cols), jnp.int32)
        qs = jnp.where(valid, q, row_idx.shape[0])
        return out.at[qs, col].add(jnp.where(valid, self.values[fc], 0),
                                   mode="drop")

    def get_column(self, col: int) -> jax.Array:
        """Sorted row indices with the given column set (host-sized)."""
        mask = self.cols == col
        return self.rows[jnp.nonzero(mask)[0]]

    def slice_rows(self, row_idx: jax.Array, max_row_nnz: int
                   ) -> Tuple[jax.Array, jax.Array]:
        """(Q, max_row_nnz) padded column ids per row (-1 padding) and
        per-row counts — the get_rows equivalent with static shapes."""
        lo, hi = self.row_ranges(row_idx)
        counts = hi - lo
        offs = jnp.arange(max_row_nnz, dtype=jnp.int32)[None, :]
        flat = lo[:, None] + offs
        ok = offs < counts[:, None]
        col = self.cols[jnp.clip(flat, 0, max(self.nnz - 1, 0))]
        return jnp.where(ok, col, -1), counts

    # -- serialization -----------------------------------------------------

    def to_npz_dict(self, prefix: str = "") -> dict:
        d = {prefix + "rows": np.asarray(self.rows),
             prefix + "cols": np.asarray(self.cols),
             prefix + "shape": np.array([self.num_rows, self.num_cols])}
        if self.values is not None:
            d[prefix + "values"] = np.asarray(self.values)
        return d

    @staticmethod
    def from_npz_dict(d, prefix: str = "") -> "RowSparse":
        shape = d[prefix + "shape"]
        values = d.get(prefix + "values") if hasattr(d, "get") else (
            d[prefix + "values"] if prefix + "values" in d else None)
        return RowSparse(
            rows=jnp.asarray(d[prefix + "rows"]),
            cols=jnp.asarray(d[prefix + "cols"]),
            num_rows=int(shape[0]), num_cols=int(shape[1]),
            values=None if values is None else jnp.asarray(values))


def register_pytrees():
    jax.tree_util.register_dataclass(
        RowSparse, ["rows", "cols", "values"], ["num_rows", "num_cols"])


register_pytrees()
