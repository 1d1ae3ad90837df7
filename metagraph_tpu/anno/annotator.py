"""Label dictionary + annotator frontends.

Replaces the reference LabelEncoder
(metagraph/src/annotation/representation/base/annotation.hpp:87-125) and
the ColumnCompressed construction annotator
(representation/column_compressed/annotate_column_compressed.hpp:24):
labels are accumulated as (row, label) COO batches on the host and
finalized into a sorted RowSparse device matrix in one sort — the device
analog of flushing per-label build buffers into sparse bit vectors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .matrix import RowSparse


class LabelEncoder:
    def __init__(self, labels: Sequence[str] = ()):
        self._labels: List[str] = []
        self._index: Dict[str, int] = {}
        for l in labels:
            self.insert(l)

    def insert(self, label: str) -> int:
        if label not in self._index:
            self._index[label] = len(self._labels)
            self._labels.append(label)
        return self._index[label]

    def encode(self, label: str) -> int:
        return self._index[label]

    def decode(self, code: int) -> str:
        return self._labels[code]

    def __contains__(self, label: str) -> bool:
        return label in self._index

    def __len__(self) -> int:
        return len(self._labels)

    @property
    def labels(self) -> List[str]:
        return list(self._labels)


class ColumnAnnotator:
    """Construction-time annotator: accumulate (row, label) pairs, then
    finalize into a RowSparse matrix (deduped; values summed for counts)."""

    def __init__(self, num_rows: int):
        self.num_rows = num_rows
        self.encoder = LabelEncoder()
        self._rows: List[np.ndarray] = []
        self._cols: List[np.ndarray] = []
        self._vals: List[np.ndarray] = []
        self._has_values = False

    def add(self, rows: np.ndarray, label: str,
            values: Optional[np.ndarray] = None):
        code = self.encoder.insert(label)
        rows = np.asarray(rows, np.int32)
        self._rows.append(rows)
        self._cols.append(np.full(rows.shape, code, np.int32))
        if values is not None:
            self._has_values = True
            self._vals.append(np.asarray(values, np.int32))
        elif self._has_values:
            self._vals.append(np.ones(rows.shape, np.int32))

    def finalize(self) -> "Annotation":
        if self._rows:
            rows = np.concatenate(self._rows)
            cols = np.concatenate(self._cols)
            vals = np.concatenate(self._vals) if self._has_values else None
        else:
            rows = np.zeros((0,), np.int32)
            cols = np.zeros((0,), np.int32)
            vals = None
        mat = RowSparse.from_coo(rows, cols, self.num_rows,
                                 max(len(self.encoder), 1), values=vals)
        return Annotation(matrix=mat, encoder=self.encoder)


@dataclass
class Annotation:
    """A finalized annotation: matrix + label dictionary (the reference's
    MultiLabelEncoded frontend, annotation.hpp:129). ``matrix`` is any
    representation with the RowSparse query API (RowSparse, Brwt,
    RowDiff, ...); the on-disk container records which."""
    matrix: object
    encoder: LabelEncoder

    @property
    def num_labels(self) -> int:
        return len(self.encoder)

    @property
    def representation(self) -> str:
        return type(self.matrix).__name__.lower()

    def save(self, path: str):
        d = self.matrix.to_npz_dict()
        # fixed-dtype unicode array: loadable with allow_pickle=False, so a
        # crafted .npz cannot execute code on load
        d["labels"] = np.array(self.encoder.labels, dtype=np.str_)
        np.savez_compressed(path, **d)

    @staticmethod
    def load(path: str) -> "Annotation":
        with np.load(path, allow_pickle=False) as d:
            keys = set(d.keys())
            labels = [str(x) for x in d["labels"]]
            if "ur_codes" in keys:
                from .unique_row import UniqueRow
                mat = UniqueRow.from_npz_dict(d)
            elif "irdb_anchor" in keys:
                from .int_brwt import IntRowDiffBrwt
                mat = IntRowDiffBrwt.from_npz_dict(d)
            elif "ibrwt_ptr" in keys:
                from .int_brwt import IntBrwt
                mat = IntBrwt.from_npz_dict(d)
            elif "trd_anchor" in keys:
                from .coords import TupleRowDiff
                mat = TupleRowDiff.from_npz_dict(d)
            elif "rdb_anchor" in keys:
                from .row_diff import RowDiffBrwt
                mat = RowDiffBrwt.from_npz_dict(d)
            elif "coord_shape" in keys:
                from .coords import CoordMatrix
                mat = CoordMatrix.from_npz_dict(d)
            elif "brwt_shape" in keys:
                from .brwt import Brwt
                mat = Brwt.from_npz_dict(d)
            elif "rd_anchor_prefix" in keys:
                from .row_diff import RowDiff
                mat = RowDiff.from_npz_dict(d)
            elif "ird_rows" in keys:
                from .row_diff import IntRowDiff
                mat = IntRowDiff.from_npz_dict(d)
            else:
                mat = RowSparse.from_npz_dict(d)
        return Annotation(matrix=mat, encoder=LabelEncoder(labels))

    @staticmethod
    def merge(parts: Sequence["Annotation"], num_rows: int) -> "Annotation":
        """Merge annotators over the same row space (merge_load,
        annotate_column_compressed.hpp:83)."""
        enc = LabelEncoder()
        rows, cols, vals = [], [], []
        has_vals = any(p.matrix.values is not None for p in parts)
        for p in parts:
            remap = np.array([enc.insert(l) for l in p.encoder.labels],
                             np.int32)
            r = np.asarray(p.matrix.rows)
            c = remap[np.asarray(p.matrix.cols)] if len(remap) else np.asarray(p.matrix.cols)
            rows.append(r)
            cols.append(c)
            if has_vals:
                v = (np.asarray(p.matrix.values) if p.matrix.values is not None
                     else np.ones_like(r))
                vals.append(v)
        rows = np.concatenate(rows) if rows else np.zeros((0,), np.int32)
        cols = np.concatenate(cols) if cols else np.zeros((0,), np.int32)
        v = np.concatenate(vals) if vals else None
        mat = RowSparse.from_coo(rows, cols, num_rows, max(len(enc), 1),
                                 values=v)
        return Annotation(matrix=mat, encoder=enc)
