"""Coordinate annotations: per-(row, label) k-mer coordinate sets.

Re-design of the reference tuple matrices (TupleCSCMatrix,
metagraph/src/annotation/int_matrix/base/int_matrix.hpp:34,
tuple_csc_matrix.hpp:24) used by ``annotate --coordinates`` and
``query --query-coords``: coordinates are stored as flat (row, col,
coord) triples sorted lexicographically, so per-pair coordinate sets are
contiguous ranges found by one batched binary search — the same
interval-expand machinery as RowSparse.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import jax.numpy as jnp
import numpy as np


def _split_triples(q, qq, cc, tt, num_cols):
    """Group flat (query-index, col, coord) triples — already sorted by
    (qq, cc, tt) — into {row: {col: coords}} dicts, looping over GROUPS
    of the sorted output rather than over query rows."""
    out = {int(r): {} for r in q}
    if len(qq):
        qc = qq * (num_cols + 1) + cc
        starts = np.concatenate(
            [[0], np.nonzero(qc[1:] != qc[:-1])[0] + 1, [len(qc)]])
        for s, e in zip(starts[:-1], starts[1:]):
            out[int(q[qq[s]])][int(cc[s])] = tt[s:e]
    return out


@dataclass
class CoordMatrix:
    rows: np.ndarray        # (nnz,) int64, sorted
    cols: np.ndarray        # (nnz,) int32, sorted within row
    coords: np.ndarray      # (nnz,) int64, sorted within (row, col)
    num_rows: int
    num_cols: int

    @property
    def nnz(self) -> int:
        return len(self.rows)

    @staticmethod
    def from_triples(rows, cols, coords, num_rows, num_cols) -> "CoordMatrix":
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int32)
        coords = np.asarray(coords, np.int64)
        order = np.lexsort((coords, cols, rows))
        rows, cols, coords = rows[order], cols[order], coords[order]
        # dedupe exact triples
        if len(rows):
            keep = np.concatenate([[True],
                                   (rows[1:] != rows[:-1])
                                   | (cols[1:] != cols[:-1])
                                   | (coords[1:] != coords[:-1])])
            rows, cols, coords = rows[keep], cols[keep], coords[keep]
        return CoordMatrix(rows, cols, coords, num_rows, num_cols)

    def pair_key(self, r, c):
        return np.asarray(r, np.int64) * self.num_cols + np.asarray(c, np.int64)

    def get_tuples(self, query_rows: np.ndarray, col: int
                   ) -> List[List[int]]:
        """Coordinate tuple per query row for one label column
        (reference MultiIntMatrix::get_row_tuples)."""
        keys = self.pair_key(self.rows, self.cols)
        q = self.pair_key(query_rows, np.full(len(query_rows), col))
        lo = np.searchsorted(keys, q, side="left")
        hi = np.searchsorted(keys, q, side="right")
        return [list(self.coords[l:h]) for l, h in zip(lo, hi)]

    def columns_of_rows(self, query_rows: np.ndarray) -> np.ndarray:
        """(Q, num_cols) bool presence."""
        out = np.zeros((len(query_rows), self.num_cols), bool)
        keys = self.rows
        lo = np.searchsorted(keys, query_rows, side="left")
        hi = np.searchsorted(keys, query_rows, side="right")
        for i, (l, h) in enumerate(zip(lo, hi)):
            out[i, np.unique(self.cols[l:h])] = True
        return out

    # serialization inside the Annotation container
    def to_npz_dict(self) -> dict:
        return {"coord_rows": self.rows, "coord_cols": self.cols,
                "coord_coords": self.coords,
                "coord_shape": np.array([self.num_rows, self.num_cols])}

    @staticmethod
    def from_npz_dict(d) -> "CoordMatrix":
        shape = d["coord_shape"]
        return CoordMatrix(np.asarray(d["coord_rows"]),
                           np.asarray(d["coord_cols"]),
                           np.asarray(d["coord_coords"]),
                           int(shape[0]), int(shape[1]))

    # RowSparse-compatible query surface (binary part)
    def presence(self, rows) -> np.ndarray:
        return self.columns_of_rows(np.asarray(rows))

    def sum_rows(self, rows, weights) -> np.ndarray:
        dense = self.columns_of_rows(np.asarray(rows))
        return (dense * np.asarray(weights)[:, None]).sum(axis=0)

    def tuples_for_rows(self, rows):
        """{row: {col: sorted coord array}} for the (unique) query rows,
        fetched in one batched interval-expand (the per-batch analog of
        the reference's get_row_tuples, tuple_csc_matrix.hpp:24)."""
        q = np.unique(np.asarray(rows, np.int64))
        lo = np.searchsorted(self.rows, q, side="left")
        hi = np.searchsorted(self.rows, q, side="right")
        sizes = hi - lo
        from .row_diff import _interval_expand
        flat = _interval_expand(lo, sizes)
        qq = np.repeat(np.arange(len(q)), sizes)
        cc = self.cols[flat]
        tt = self.coords[flat]
        return _split_triples(q, qq, cc, tt, self.num_cols)


@dataclass
class TupleRowDiff:
    """Coordinate sets delta-compressed along graph successor paths
    (reference TupleRowDiff, int_matrix/row_diff/tuple_row_diff.hpp:27):
    each non-anchor row stores the symmetric difference of its
    coordinate set against the successor's coordinates shifted by
    SHIFT=-1 (coordinates advance by one per edge), so unitig interiors
    store nothing. Queries walk to an anchor and fold the diffs back."""
    diffs: CoordMatrix
    anchor: np.ndarray           # (num_rows,) bool
    succ: np.ndarray             # (num_rows,) int64 (-1 = none)
    max_length: int

    SHIFT = 1

    @property
    def num_rows(self) -> int:
        return self.diffs.num_rows

    @property
    def num_cols(self) -> int:
        return self.diffs.num_cols

    @property
    def nnz(self) -> int:
        return self.diffs.nnz

    # -- reconstruction ----------------------------------------------------

    def _reconstruct_rows(self, rows: np.ndarray):
        """{row: {col: sorted coord array}} for the requested rows.

        Fully batched (no per-row host walks): the
        closed form of the recurrence T(v) = symdiff(D(v), T(succ(v)) -
        SHIFT) is T(v0) = Δ_i (D(v_i) - i*SHIFT) over the anchor path
        v_0..v_m, so reconstruction is (1) one vectorized pointer walk
        collecting (query, path node, depth) records for ALL rows at
        once, (2) one interval-expand gathering every path node's diff
        triples with the depth shift applied, (3) one lexsort +
        odd-count filter for the symmetric difference (triples that
        appear an even number of times cancel)."""
        q = np.unique(np.asarray(rows, np.int64))
        if len(q) == 0:
            return {}
        # (1) batched anchor walk
        cur = q.copy()
        alive = np.arange(len(q))
        qi_parts, node_parts, depth_parts = [], [], []
        for d in range(self.max_length + 1):
            qi_parts.append(alive)
            node_parts.append(cur)
            depth_parts.append(np.full(len(cur), d, np.int64))
            go = ~self.anchor[cur] & (self.succ[cur] >= 0)
            if not go.any():
                break
            alive, cur = alive[go], self.succ[cur[go]]
        qi = np.concatenate(qi_parts)
        nodes = np.concatenate(node_parts)
        depths = np.concatenate(depth_parts)
        # (2) gather all path diffs, shifted back by depth
        m = self.diffs
        lo = np.searchsorted(m.rows, nodes, side="left")
        hi = np.searchsorted(m.rows, nodes, side="right")
        sizes = hi - lo
        from .row_diff import _interval_expand
        flat = _interval_expand(lo, sizes)
        qq = np.repeat(qi, sizes)
        cc = m.cols[flat]
        tt = m.coords[flat] - np.repeat(depths, sizes) * self.SHIFT
        # (3) symdiff: triples with odd multiplicity survive
        order = np.lexsort((tt, cc, qq))
        qq, cc, tt = qq[order], cc[order], tt[order]
        first = np.concatenate([[True], (qq[1:] != qq[:-1])
                                | (cc[1:] != cc[:-1])
                                | (tt[1:] != tt[:-1])])
        group = np.cumsum(first) - 1
        counts = np.bincount(group) if len(group) else np.zeros(0, np.int64)
        fidx = np.nonzero(first)[0]
        keep = fidx[(counts % 2) == 1]
        qq, cc, tt = qq[keep], cc[keep], tt[keep]
        return _split_triples(q, qq, cc, tt, self.num_cols)

    def tuples_for_rows(self, rows):
        """Batched {row: {col: coords}} (see CoordMatrix.tuples_for_rows)."""
        return self._reconstruct_rows(rows)

    # -- CoordMatrix-compatible query surface ------------------------------

    def get_tuples(self, query_rows: np.ndarray, col: int) -> List[List[int]]:
        q = np.asarray(query_rows, np.int64)
        ok = (q >= 0) & (q < self.num_rows)
        rec = self._reconstruct_rows(np.unique(q[ok]))
        out = []
        for r, valid in zip(q, ok):
            if not valid:
                out.append([])
                continue
            t = rec[int(r)].get(col)
            out.append(sorted(int(x) for x in t) if t is not None else [])
        return out

    def columns_of_rows(self, query_rows: np.ndarray) -> np.ndarray:
        q = np.asarray(query_rows, np.int64)
        out = np.zeros((len(q), self.num_cols), bool)
        ok = (q >= 0) & (q < self.num_rows)
        rec = self._reconstruct_rows(np.unique(q[ok]))
        for i, (r, valid) in enumerate(zip(q, ok)):
            if valid:
                for c in rec[int(r)]:
                    out[i, c] = True
        return out

    def presence(self, rows) -> np.ndarray:
        return self.columns_of_rows(np.asarray(rows))

    def sum_rows(self, rows, weights) -> np.ndarray:
        dense = self.columns_of_rows(np.asarray(rows))
        return (dense * np.asarray(weights)[:, None]).sum(axis=0)

    # -- serialization -----------------------------------------------------

    def to_npz_dict(self) -> dict:
        d = {("trd_" + k): v for k, v in self.diffs.to_npz_dict().items()}
        d["trd_anchor"] = np.packbits(self.anchor)
        d["trd_anchor_len"] = np.array(len(self.anchor))
        d["trd_succ"] = self.succ
        d["trd_max_length"] = np.array(self.max_length)
        return d

    @staticmethod
    def from_npz_dict(d) -> "TupleRowDiff":
        inner = {k[len("trd_"):]: d[k] for k in d.keys()
                 if k.startswith("trd_coord_")}
        n = int(d["trd_anchor_len"])
        return TupleRowDiff(
            diffs=CoordMatrix.from_npz_dict(inner),
            anchor=np.unpackbits(d["trd_anchor"])[:n].astype(bool),
            succ=np.asarray(d["trd_succ"]),
            max_length=int(d["trd_max_length"]))


def build_tuple_row_diff(matrix: CoordMatrix, graph,
                         max_length: int = 64) -> TupleRowDiff:
    """Delta-compress a coordinate annotation along successor paths:
    D(v) = symdiff(T(v), T(succ(v)) - SHIFT) per column; anchors store
    full coordinate sets."""
    from .row_diff import assign_successors_and_anchors
    succ, anchor = assign_successors_and_anchors(graph, max_length)
    rows = matrix.rows
    cols = matrix.cols
    coords = matrix.coords
    C = matrix.num_cols
    # keys: (row, col, coord) triple as two int64s for xor-cancellation
    base_key = (rows * C + cols)
    # successor triples pulled onto each non-anchor row, shifted by -1
    v_ids = np.nonzero(~anchor)[0]
    sv = succ[v_ids]
    okm = sv >= 0
    v_ids, sv = v_ids[okm], sv[okm]
    lo = np.searchsorted(rows, sv, side="left")
    hi = np.searchsorted(rows, sv, side="right")
    sizes = hi - lo
    vv = np.repeat(v_ids, sizes)
    from .row_diff import _interval_expand
    flat = _interval_expand(lo, sizes)
    all_rows = np.concatenate([rows, vv])
    all_cols = np.concatenate([cols, cols[flat]])
    all_coords = np.concatenate(
        [coords, coords[flat] - TupleRowDiff.SHIFT])
    # triples appearing an odd number of times survive (symdiff)
    order = np.lexsort((all_coords, all_cols, all_rows))
    r_s, c_s, t_s = (all_rows[order], all_cols[order], all_coords[order])
    first = np.concatenate([[True], (r_s[1:] != r_s[:-1])
                            | (c_s[1:] != c_s[:-1])
                            | (t_s[1:] != t_s[:-1])])
    group = np.cumsum(first) - 1
    counts = np.bincount(group)
    fidx = np.nonzero(first)[0]
    odd = (counts % 2) == 1
    keep = fidx[odd]
    diffs = CoordMatrix(rows=r_s[keep], cols=c_s[keep],
                        coords=t_s[keep], num_rows=matrix.num_rows,
                        num_cols=C)
    return TupleRowDiff(diffs=diffs, anchor=anchor, succ=succ,
                        max_length=max_length)


class CoordAnnotator:
    """Accumulates (row, label, coordinate) triples during annotation
    (reference annotate.cpp:384 annotate_coordinates)."""

    def __init__(self, num_rows: int):
        from .annotator import LabelEncoder
        self.num_rows = num_rows
        self.encoder = LabelEncoder()
        self._r: List[np.ndarray] = []
        self._c: List[np.ndarray] = []
        self._x: List[np.ndarray] = []

    def add(self, rows: np.ndarray, label: str, coords: np.ndarray):
        code = self.encoder.insert(label)
        rows = np.asarray(rows, np.int64)
        self._r.append(rows)
        self._c.append(np.full(len(rows), code, np.int32))
        self._x.append(np.asarray(coords, np.int64))

    def finalize(self):
        from .annotator import Annotation
        if self._r:
            r = np.concatenate(self._r)
            c = np.concatenate(self._c)
            x = np.concatenate(self._x)
        else:
            r = np.zeros(0, np.int64)
            c = np.zeros(0, np.int32)
            x = np.zeros(0, np.int64)
        mat = CoordMatrix.from_triples(r, c, x, self.num_rows,
                                       max(len(self.encoder), 1))
        return Annotation(matrix=mat, encoder=self.encoder)


def annotate_coordinates(graph, items: Sequence[Tuple[bytes, Sequence[str]]],
                         annotator: CoordAnnotator = None) -> CoordAnnotator:
    """items: (sequence, labels); coordinate of window i in a sequence is
    its offset within that sequence's coordinate space (consecutive
    sequences of one label continue the coordinate axis, as the
    reference's per-file coordinate systems do)."""
    if annotator is None:
        num_rows = graph.num_nodes()
        if hasattr(graph, "node_to_anno_row"):
            num_rows = graph.base.num_nodes()
        annotator = CoordAnnotator(num_rows=num_rows)
    offsets = {}
    for seq, labels in items:
        nodes = graph.map_to_nodes(seq)
        present = nodes > 0
        if hasattr(graph, "node_to_anno_row"):
            rows = graph.node_to_anno_row(nodes[present])
        else:
            rows = nodes[present].astype(np.int64) - 1
        for label in labels:
            off = offsets.get(label, 0)
            coords = off + np.nonzero(present)[0]
            annotator.add(rows, label, coords)
            offsets[label] = off + len(nodes)
    return annotator
